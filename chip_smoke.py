#!/usr/bin/env python3
"""Smoke run of the PyTorch / H100 port (scat_tpu_torch) on one CUDA card.

    python3 chip_smoke.py        # from the root of a checkout
    python3 chip_smoke.py train group-norm   # only these phases (and
                                 # build, and what they need); no result

Phases, in order; any failure raises and exits non-zero:
  1. build    compile every kernel source under scat_tpu_torch/csrc
              (one nvcc each, in parallel), print what ptxas reports
              (registers, shared memory, spills) for the six bf16
              tensor-core kernels and the fused link (the four wgmma
              kernels fed by TMA, the persistent attention forward and
              backward, the FAVOR+ stats and the fused link, must not
              spill), and the card's name and power limit;
  2. kernels  each kernel against its plain PyTorch version on the card
              at the serving and training paths' shapes: float32 (TF32
              off) at atol 2e-5, bfloat16 at atol = rtol = 1e-2 against
              the plain version run in float32 on the same bf16 inputs,
              and within 2 bf16 ulps of it rounded to bf16 (P and dS
              split into bf16 high and low parts; the forward's gap at
              the training shape printed beside the 1.10e-2 of the
              design that rounded P to bf16);
              flash_attention's autograd against autograd through the
              plain forward; then each kernel timed beside its plain
              version and the library call (SDPA's forward; SDPA's
              backward alone, through one saved forward; and the
              forward+backward pairs), each beside its bound; also at
              the 128-token heads' [96, 8, 128, 64] (both directions'
              persistent wgmma kernels beside SDPA and their bounds: the
              kernels line's ms_n128, bound_ms_n128, library_ms_n128),
              with each kernel's blocks an SM holds and shared memory a
              block (the occupancy API) at N 21 and 128 and the wgmma
              kernels' registers; both persistent kernels at N 65, 80,
              97, 100, 127 and 128 in bf16 and float32 and at pair counts
              that are not a multiple of their grid, their launch plans
              against forward_plan's and backward_plan's, the backward
              bit for bit the same on a second launch;
  3. link     the fused 1x1-convolution link (ops/fused_link.py) against
              its plain version on the card at the probe's five shapes
              (ResNet-50's bottleneck links at bs 96,
              benchmarks/probe_fused_link.py:112-118), at M of 1, 129,
              3136 and 4704 (not whole 128-row tiles) and at N = 1024: y
              within 1 bf16 ulp at max|y| of the plain version run in
              float32 on the same bf16 inputs, s within 1e-5 of the
              column's sum of |y| and ss within 2e-5 of itself (each plus
              one row's float32 rounding, ops/fused_link.link_gaps), a
              second launch and, at the probe's shapes, a CUDA-graph
              replay bit for bit the same; each shape's plan
              (ops/fused_link.link_plan: tile, consumer warpgroups,
              blocks, busiest block, block slots busy, w resident or
              streamed, stages, shared memory against the kernel's own
              count, bytes through the L2, ptxas registers and spills of
              the instantiation it launches); the flagship's own
              links (resnet50 at full width in train mode, bf16, bs 96, a
              synthetic batch, seed 0), hooked at layer1.0 and layer2.0
              (bn2 -> conv3), layer1.1, layer2.1 and layer3.1 (conv1):
              fused_link on the hooked inputs (bn2's batch statistics and
              affine folded into scale and shift) against the module
              chain's conv output within 2% of its largest magnitude, the
              next BatchNorm's batch statistics as sums against those of
              the kernel's y within 1e-3 and against its s and ss (of the
              float32 product before rounding) within 1e-3 plus y's
              rounding, the launches counted there; then device times
              at the five shapes: the kernel (and its second launch), the
              plain version, the unfused PyTorch chain (the probe's
              xla_link: prologue, cuBLAS product, two reductions;
              library_ms) and cuBLAS's product alone on a ready xn, each
              beside the bound, and the chain / kernel ratio against the
              probe's 1.2 gate; layer3's shape again with x rotated over
              3 copies in the graph (not L2-warm), and the second launch
              (the ordered sum of the blocks' partials) timed alone;
              fused_link's counter reads 0 after every other phase (no
              model path calls it, as in JAX);
  4. slice    the flagship --net reg_transformer predictor at full width
              (resnet50, 224x224 crops, 784-dim tokens, 8 heads,
              iteration 3, bfloat16, weights from seed 0) serves uint8
              requests of 1, 7, 64 and 150 crops and one float32 request;
              outputs are checked, the attention kernel must run 3 times
              per forward chunk, and the predictor must agree with the
              same predictor on the plain attention path; then the
              end-to-end rate (all crops of a window of back-to-back
              640-crop requests over its wall time) and, per bucket, the
              p50 request latency are printed;
  5. serve    the HTTP front end answers POST /predict (also with
              micro-batching on) with exactly what predict returns, and
              GET /healthz;
  6. export   the flagship (bf16, and a float32 copy, TF32 off) and
              --net ViP (bf16) at full width exported by export_predictor
              to build/ (export time and artifact size printed) and loaded
              as ExportedPredictor: a fresh process serves the flagship's
              artifact with no scat_tpu_torch.models module imported; each
              program holds 3 attention_fwd nodes (ViP: 3 favor_stats and 3
              favor_apply); warmup captures one CUDA graph per (bucket,
              dtype), 14, counting 3 launches of each kernel in each
              capture and in its eager warm-up run, and the runners'
              replay tally 3 in the replay of each; the artifact
              against the live predictor on uint8 requests of 1, 7, 64 and 150
              crops and one float32 request (bf16: within 2% of the
              largest magnitude, the gap printed; float32: 1e-4, joints_2d
              1e-4 of their 112 pixels a unit); live and artifact in turns
              on the same 6 x 640 window (ViP 3 x 256), p50 request latency
              at buckets 1 and 64, the device idle share of a 256-crop
              request each, and a profile of the replayed request that
              counts the hand-written kernels (3 a chunk), the graph
              launches (1 a chunk), no eager layer op, no counted launch
              and the runners' replay tally 3 a chunk, as the profile;
              scat_tpu_torch.server --serve_artifact in a process of its
              own answers POST /predict as predict does, and GET /healthz
              names the artifact;
  7. train    the Trainer at the canonical run's configuration
              (script/ablation_pose.sh on the synthetic task: resnet50,
              bs 96, 224x224, 8 heads, iteration 3, mask_rate 0.2, bf16
              compute, Adam with the warmup, seed 0) for 3 epochs of 8
              steps: finite losses, 3 forward and 3 backward attention
              launches per step, a falling loss; one step's loss and
              gradient norm against the plain attention path; a
              grad_accum 2 step; hand_net_final.pth served by
              HandPosePredictor; the eval step's PCK and MPJPE; then the
              training rate, p50 step time and a profile; then 5 steps
              with --debug True (its default), --profile_trace_dir and
              --tensorboard True: the debug grid or matplotlib's skip
              message, tensorboardX's events or its CSV-only message, and
              a Chrome trace whose device kernels name both attention
              kernels;
  8. stb      an STB tree written under build/ (two training and two
              evaluation sequences of 96 smooth 640x480 PNG frames and
              their label pickles): which decoder serves (the native
              library or PIL) and the loader's ms per batch of 96 by
              stage; the canonical run at --stage 3 --synthetic_data
              False for 2 epochs of 2 steps (3 + 3 attention launches a
              step, finite losses, hand_net_final.pth), its rate, p50
              step and device idle share through the loader beside the
              synthetic task's; the Evaluator on STB_eval from that
              checkpoint at bs 96 (3 launches a batch, finite MPJPE, AUC
              and PCK, against the same batches on the plain attention
              path: MPJPE within 1%, AUC within 1e-3 of its full scale)
              and its crops/s; predict_from_frames on 7 frames against
              frames_to_crops then predict;
  9. datasets FreiHAND (224x224 JPEG), HO-3D (640x480 PNG), MHP (640x480
              JPEG, data_15 webcam 1) and RHD (320x320 PNG) trees of 192
              samples written under build/ beside an STB tree: each
              loader's ms per batch of 96 by stage (host decode, labels,
              FreiHAND's colour jitter, upload and warp on the card, the
              whole batch); the canonical run at --stage 2 --synthetic_data
              False for 2 epochs through all five loaders (one step per
              member of each tuple, 3 + 3 attention launches a member step,
              label widths 166, 166, 105, 105, 105, a finite loss each,
              each metrics.csv row its tuple's mean), its rate, p50 member
              step and device idle share; the Evaluator on frei and ho3d
              from its checkpoint (3 launches a batch, against the plain
              attention path on the same batches: MPJPE within 1%, AUC
              within 1e-3 of its full scale) and its crops/s; DemoRunner on
              STB's B1Counting and MHP's data_15_cam_1 (3 launches a frame,
              finite MPJPE, ACC and AUC, the same bounds against the plain
              path) and its frames/s;
  10. group-norm  the flagship with --norm_layer group: requests of 1 and
              64 crops (3 launches a chunk, against the plain attention
              path within 2%), p50 request latencies at buckets
              1 and 64 beside BatchNorm's predictor; 8 synthetic training
              steps at bs 96 (3 + 3 launches a step, a falling loss, one
              step against the plain attention path) and the training
              rate, p50 step and device time a step beside the train
              phase's;
  11. coarse   --net reg_transformer_coarse at the widths of
              script/ablation_pose.sh (resnet50, 21 tokens x 784, 8
              heads, depth 3, bf16, seed 0): requests of 1 and 64 crops
              and HTTP answers equal to predict; train_coarse's flag line
              (bs 96, mask_rate 0.2, 3 epochs of 8 steps, --debug False):
              a falling loss, hand_net_final.pth served equal to the
              trained model; one --pl_reg True step, finite; the Evaluator
              with --debug True on 2 synthetic batches of 96: the
              attention dump attn/{finger}/NNN.png (or its skip message
              without cv2), the eval step's attn [96, 8, 21, 21] with rows
              summing to 1 (bf16: within the rounding of their entries;
              float32: 1e-5); the training rate and a profile; no
              attention-kernel launch anywhere (the coarse head's
              attention is the plain version: it returns P);
  12. token-heads  backbone_hrnet (HRNet-W24, 56x56x128 read as 512 x
              28x28) and backbone_incepv3 (768x12x12 read as 192 x
              24x24), each to 128 tokens x 196, 8 heads, depth 3,
              iteration 3, seed 0, built by the factory, which routes
              them to the kernels under --use_pallas_attention: eval
              forwards at bs 1, 64 and 96 with the kernels against the
              plain path (use_kernel off) on the same
              weights (pred less its mean within 2% in bf16, 1e-3 in
              float32; 3 attention_fwd launches at N = 128 a forward);
              a train-mode forward+backward at bs 96, bf16, 25 of the 128
              tokens masked, on the surrogate pred.float().square().mean()
              (3 + 3 launches; loss and gradient norm within 2%); device
              ms a forward and a forward+backward on each path, and the
              kernels' share of device time;
  13. vit      --net ViT at the JAX package's defaults (224 px, 16x16
              patches, 197 tokens x 256, depth 3, 8 heads x 64, iteration
              1, bf16, seed 0; the plain attention, as in JAX): requests
              of 1, 7, 64 and 150 crops and HTTP equal to predict; the
              float32 forward on the card (TF32 off) against the CPU on
              the same weights within 1e-4 of the joints; the Trainer at
              bs 96, lr 5e-4, weights 1e5 / 10 for 3 epochs of 8 steps (a
              falling loss, hand_net_final.pth served as it is); the
              Evaluator on 2 synthetic batches (finite MPJPE, AUC, PCK);
              the serving rate, p50 request latency at buckets 1 and 64,
              the training rate, p50 step and profiles; no attention-kernel
              launch;
  14. mano     --net frankmocap (H3DW on resnet50, 224 px, bf16, the
              synthetic MANO of extra_data/hand.obj): rot_pose_beta_to_mesh
              in float32 on the card against the CPU at bs 96 within 1e-5
              (bf16 inputs decode in float32), its device ms and kernel
              launches a call; the Tester on 16 PNG crops written under
              build/ (finite params, joints, vertices and 2D joints, the
              parameter files, the overlays or their skip message) and its
              images/s; the Evaluator through H3DWJointsEncoder on 2
              synthetic batches of 96;
  15. video    VideoTrainer at the JAX package's defaults (resnet50 H3DW at
              224 px, bf16; 16-frame windows at stride 8, 2 a step; GRU
              1024 x 2, attention pooling; VIBELossConfig()) for 2 epochs
              over 4 videos x 48 frames from seed 0: finite generator and
              discriminator losses with d_real and d_fake; the
              discriminator's parameters unchanged by the generator's
              update; one step against the same step with the encoder in
              float32 (losses within 2%); sequences/s, p50 step, the
              synchronising calls of a step, a profile, and the step's
              parts (encoder, MANO decode, GRU, losses) each timed alone;
  16. favor    the FAVOR+ stats and apply kernels against their plain
              versions at --net ViP's shapes (BH 4, 28, 256, 384 at
              T = 3137, e = 128, m = 64; T at chunk, slab, round and
              tile edges; e 96; e 64 / m 32) at rtol 1e-4 (atol 1e-5,
              times the largest
              magnitude for the stats' sums over T): the stats against
              the float32 plain version fed the operands' float32 values;
              the apply on the kernel's stats, and the stats and apply
              chain, against the plain versions in float32 (float32
              operands, which share their arithmetic) or run in float64
              (bf16 operands: the bf16x3 tensor-core kernels are closer
              to float64 than the float32 plain versions are), the
              float32 plain apply's distance printed beside; the bf16
              stats' kptv off float64 at the training shape, at most the
              mma.sync design's 2.8e-6 of its largest magnitude; the
              backward kernels (favor_bwd_q, favor_bwd_kv) at ViP's
              training shape, a ragged T with e 72 / m 16 and e 36,
              float32 and bf16, against the closed form in float64
              (within 1e-5 of the largest magnitude past rtol 1e-4 and
              the output's rounding; the share of bf16 outputs off
              float64's rounding printed), bit for bit alike twice;
              favor_attention_fused's output against favor_attention in
              float32 and its gradients against autograd through it in
              float64; then each kernel timed beside its plain version,
              and the plain three-einsum path (no single PyTorch call
              computes FAVOR+, so no library time), each forward kernel's
              bound both as its tensor-core design's (bytes, and the
              bf16x3 products) and as the float32-operation figure, the
              backward's as portbench's favor_bwd_roofline.train reckons
              it, beside autograd's float32 recompute it replaced;
  17. vip-serve  the --net ViP predictor at full width (224 px, 3137
              tokens x 512, 4 heads, depth 3, m 64, iteration 3, bf16,
              --use_pallas_favor True, weights from seed 0) serves uint8
              requests of 1, 7, 64 and 150 crops: 3 stats + 3 apply
              launches per forward chunk and none of attention; kernel
              vs plain FAVOR+ in float32 (1e-3), bf16 against the same
              model with the plain float32 FAVOR+ substituted (2%); the
              end-to-end rate, p50 request latency at buckets 1 and 64
              and a profile;
  18. vip-train  the Trainer on --net ViP (bs 96, lr 5e-4, weights 1e5 /
              10, bf16, dropout 0.1) for 3 epochs of 8 steps: 3 + 3
              forward and 3 + 3 backward launches a step, a falling loss;
              one step's loss and gradient norm against the plain float32
              FAVOR+; remat_blocks against none (6 + 6 forward and 3 + 3
              backward launches, the same loss and gradients); hand_net_final.pth served; the training rate,
              p50 step time and a profile;
  19. vip-eval  the Evaluator on vip-train's hand_net_final.pth
              (synthetic batches): 3 + 3 FAVOR+ launches a batch and the
              file's frozen mains.{i}.w;
  20. parallel  parallel/ in an NCCL group of one process: the Trainer at
              the canonical run's widths (bs 96, bf16) under data:1 (DDP,
              BatchNorm over the group), --param_sharding fsdp (FSDP2) and
              data:1,model:1 (the Megatron split of the transformer's
              pairs), 3 steps each on the plain trainer's weights and
              batches: 3 + 3 attention launches a step, each loss within
              2% of the plain trainer's; --net ViP at full width through
              pipeline_apply at pipe:1, one step of 2 microbatches of 16
              (3 + 3 FAVOR+ launches a microbatch; loss and gradient norm
              within 2% of the blocks in sequence); the Evaluator at
              data:1 and a mesh= predictor over the card, the numbers of
              the same without a mesh;
  21. files    validate_data --n 4 on the card on written STB, FreiHAND,
              HO-3D and MHP trees of 8 samples (RHD's written K is the
              identity: its report is the rhd-projection error);
              convert --direction to_pth of train's hand_net_final.pth
              (every tensor equal) and flax_from_state_dict and back; a
              --vit_heads 4 .pth loaded into the flagship with the JAX
              package's WARNING line and served (3 launches), a bare
              torchvision ResNet .pth refused as an architecture
              mismatch; the export phase's flagship artifact: one
              weights.npz, its size and load time, 0.0 from live serving;
  22. examples  the port's example scripts (examples/*_torch.py) run
              in-process in a cwd under build/, with PyTorch's default
              TF32 settings, as a user runs them: quickstart_torch at 224
              px in float32 (24 train steps at bs 8, 3 + 3 attention
              launches a step, 3 a held-out eval batch, the p50 step, both
              evaluations' PA-MPJPE and the example's own reload assertion,
              within 1e-3 mm); serve_artifact_torch with no argument (the
              full-width bf16 flagship exported and served: export and
              load seconds, the request's one CUDA graph with 3 + 3
              launches in its capture and warm-up, none on a replay and
              3 in the runner's replay tally, the replay equal to the
              first answer, the artifact within 2% of
              the live predictor, the replayed request's p50);
              check_dataset_torch on a written STB tree (synthetic and STB
              batches on the card, FreiHAND and HO-3D skipped, the plot or
              matplotlib's skip line);
  23. the card line, the kernels line, and the final
     {"ok": true, "device": ...} line.

TF32 is off for the whole run (torch.backends.cuda.matmul.allow_tf32 and
torch.backends.cudnn.allow_tf32), so float32 comparisons are float32.
"""

import collections
import contextlib
import copy
import csv
import dataclasses
import http.client
import importlib.util
import json
import os
import pickle
import shutil
import subprocess
import sys
import tempfile
import threading
import time
import warnings

import numpy as np
import torch
import torch.nn.functional as F

from scat_tpu_torch.config import Options
from scat_tpu_torch.data import (freihand, ho3d, mhp, native_loader,
                                 preprocess, stb)
from scat_tpu_torch.data.common import load_rgb
from scat_tpu_torch.data.multi import ConcatDataset
from scat_tpu_torch.data.prefetch import prefetch_to_device, to_device
from scat_tpu_torch.data.preprocess import color_jitter_np
from scat_tpu_torch.evaluation import demo
from scat_tpu_torch.evaluation.evaluator import Evaluator
from scat_tpu_torch.evaluation.tester import Tester
from scat_tpu_torch.export import ExportedPredictor, export_predictor, op_nodes
from scat_tpu_torch.kernels import build
from scat_tpu_torch import train_coarse
from scat_tpu_torch.models import build_model, mano, performer, vibe_loss
from scat_tpu_torch.models.factory import compute_dtype
from scat_tpu_torch.models.hand_net import (EncoderTransformerCoarse,
                                            H3DWJointsEncoder)
from scat_tpu_torch.models.transformer import Attention
from scat_tpu_torch.models.vit import ViT
from scat_tpu_torch.ops.attention import (attention_bwd,
                                          attention_bwd_reference,
                                          attention_reference, bf16_ulps,
                                          flash_attention)
from scat_tpu_torch.ops.attention import (backward_plan, forward_plan,
                                          kernel_plan)
from scat_tpu_torch.ops.attention import occupancy as attention_occupancy
from scat_tpu_torch.ops.favor import (favor_apply, favor_apply_reference,
                                      favor_attention, favor_attention_fused,
                                      favor_backward_reference, favor_bwd_kv,
                                      favor_bwd_q, favor_bwd_q_reference,
                                      favor_stats, favor_stats_reference)
from scat_tpu_torch.ops import fused_link as fused_link_op
from scat_tpu_torch.ops.fused_link import (fused_link, fused_link_reference,
                                           link_gaps, link_plan)
from scat_tpu_torch.server import make_server
from scat_tpu_torch.serving import HandPosePredictor, frames_to_crops
from scat_tpu_torch.training import adversarial, steps
from scat_tpu_torch.training.adversarial import make_adversarial_train_step
from scat_tpu_torch.training.trainer import Trainer, make_dataset
from scat_tpu_torch.training.video_trainer import (VideoChunkDataset,
                                                   VideoTrainer)
from scat_tpu_torch.utils import checkpoint
from scat_tpu_torch.viz.draw import FINGER_QUERIES

# NVIDIA H100 SXM data sheet, dense rates
HBM_BYTES_PER_S = 3.35e12
PEAK_FLOPS = {torch.bfloat16: 989e12, torch.float32: 67e12}

FLAGSHIP = Options(net="reg_transformer", vit_heads=8, vit_depth=3,
                   iteration=3, compute_dtype="bfloat16",
                   use_pallas_attention=True, checkpoint_path_eval="",
                   seed=0)
# the canonical training run, script/ablation_pose.sh, on the synthetic
# task; the checkpoints go to build/, which .gitignore lists
TRAIN = dataclasses.replace(
    FLAGSHIP, batch_size=96, lr=5e-4, l_weight_3d=1e5, l_weight_2d=10.0,
    pos_embed=True, mask_rate=0.2, synthetic_data=True, debug=False,
    epoch=3, steps_per_epoch=8, log_every=1,
    checkpoint_folder=os.path.join("build", "chip_smoke_train"))
# the canonical run on an STB tree that the stb phase writes:
# --stage 3 --synthetic_data False, 2 epochs of 2 steps
STB_TRAIN = dataclasses.replace(
    TRAIN, synthetic_data=False, stage=3, epoch=2,
    checkpoint_folder=os.path.join("build", "chip_smoke_stb"))
STB_TRAIN_SEQS = ("B2Counting", "B2Random")
STB_EVAL_SEQS = ("B1Counting", "B1Random")
STB_FRAMES = 96   # frames a sequence
IMAGE = 224
HEADS, TOKENS, HEAD_DIM = 8, 21, 64
HEAD_TOKENS = 128   # the HRNet and Inception heads' tokens
TRAIN_BATCH = 96
SCALE = HEAD_DIM ** -0.5
REQUESTS = (1, 7, 64, 150)
# the bf16 attention kernels against the float32 plain version rounded to
# bf16 (ops/attention.bf16_ulps), and the forward's gap at the training
# shape when P was rounded to bf16 (an H100 80GB HBM3 at 700 W, PERF.md)
ULPS = 2
ROUNDED_P_FWD_GAP = 1.10e-2
WINDOW_REQUESTS, WINDOW_CROPS = 6, 640
# Bounds between two runs of the whole predictor that differ only in
# rounding: the kernel vs the plain attention path, and a float32 request
# vs the uint8 request of the same crops (the device normalizes uint8 by
# multiplying with 1/127.5, the host divides, so inputs differ by an ulp).
# In bf16 such a difference can flip an input's or an activation's bf16
# rounding (2^-9 relative); outputs must agree to 2% of their largest
# magnitude.  In float32 they must agree to 1e-3, the repo's model
# parity bar.
BF16_REL = 2e-2
F32_ATOL = 1e-3

# --net ViP at the JAX package's defaults (performer.py:155-178): 224 px
# crops in 4x4 patches, 3136 tokens + cls, emb_s 128 x 4 heads, depth 3,
# m = 64 features; the kernel path of FAVOR+
VIP = Options(net="ViP", iteration=3, compute_dtype="bfloat16",
              use_pallas_favor=True, checkpoint_path_eval="", seed=0)
VIP_TRAIN = dataclasses.replace(
    VIP, batch_size=96, lr=5e-4, l_weight_3d=1e5, l_weight_2d=10.0,
    synthetic_data=True, debug=False, epoch=3, steps_per_epoch=8,
    log_every=1, checkpoint_folder=os.path.join("build", "chip_smoke_vip"))
VIP_HEADS, VIP_T, VIP_E, VIP_M = 4, 3137, 128, 64
# [B, H, T, e, m]: BH 4, 28, 256 and 384 (serving buckets 1, 7, 64;
# training at bs 96) at ViP's T, e, m; T at chunk edges (32 rows for the
# float32 kernels, 64-row slabs for the bf16 stats kernel) and tile edges;
# e 64
FAVOR_SHAPES = [(b, VIP_HEADS, VIP_T, VIP_E, VIP_M) for b in (1, 7, 64, 96)]
FAVOR_SHAPES += [(2, VIP_HEADS, t, VIP_E, VIP_M)
                 for t in (1, 33, 63, 64, 65, 1048, 1049)]
FAVOR_SHAPES += [(2, 3, 257, 64, 32)]
# the bf16 stats kernel's 128-row rounds (two warpgroups of 64-row slabs)
# and e = 96 (a partial second column block of its TMA copies)
FAVOR_SHAPES += [(2, VIP_HEADS, 129, VIP_E, VIP_M)]
FAVOR_SHAPES += [(2, VIP_HEADS, t, 96, VIP_M) for t in (1, 63, 65, 1100)]
FAVOR_TRAIN = (TRAIN_BATCH, VIP_HEADS, VIP_T, VIP_E, VIP_M)
# float32 against float32 (TF32 off): rtol 1e-4; atol 1e-5 for y, and
# 1e-5 times the largest magnitude for the stats, sums over 3137 rows of
# exponentials
FAVOR_RTOL, FAVOR_ATOL = 1e-4, 1e-5
# the bf16 stats' kptv against float64 at the training shape, as a share of
# its largest magnitude: the mma.sync design's gap (an H100 80GB HBM3 at
# 700 W, PERF.md), which the wgmma design may not exceed
STATS_F64_GAP = 2.8e-6
VIP_WINDOW_REQUESTS, VIP_WINDOW_CROPS = 3, 256
# device kernels grouped by what they do, first match wins; the rest is
# elementwise arithmetic (adds, products, activations, dropout, the
# optimizer)
PROFILE_FAMILIES = (
    ("hand-written kernels", ("attention_fwd", "attention_bwd", "favor_",
                              "fused_link")),
    ("float32 GEMM", ("gemm_f32f32",)),
    ("GEMM and convolution", ("gemm", "nvjet", "xmma", "cutlass", "conv")),
    ("normalisation", ("norm",)),
    ("copies and casts", ("copy", "Memcpy", "Cat", "Memset")),
    ("reductions", ("reduce",)),
)


@dataclasses.dataclass
class Kernel:
    name: str
    route: str
    source: str
    replaces: str
    wrapper: object
    # device kernels counted as this one's in a profile
    profile_keys: tuple = ()
    result: dict = dataclasses.field(default_factory=dict)


KERNELS = [
    Kernel("attention_fwd", "cuda", "scat_tpu_torch/csrc/attention_fwd.cu",
           "scat_tpu/ops/pallas_attention.py:49", flash_attention,
           ("attention_fwd",)),
    Kernel("attention_bwd", "cuda", "scat_tpu_torch/csrc/attention_bwd.cu",
           "scat_tpu/ops/pallas_attention.py:63", attention_bwd,
           ("attention_bwd",)),
    # the stats wrapper's second launch (the sum of T-tiles) is its own
    Kernel("favor_stats", "cuda", "scat_tpu_torch/csrc/favor.cu",
           "scat_tpu/ops/pallas_favor.py:63", favor_stats,
           ("favor_stats", "favor_reduce")),
    Kernel("favor_apply", "cuda", "scat_tpu_torch/csrc/favor.cu",
           "scat_tpu/ops/pallas_favor.py:90", favor_apply,
           ("favor_apply",)),
    # on no model path (as in JAX): its launches are the link phase's run
    # on the flagship's hooked links
    Kernel("fused_link", "cuda", "scat_tpu_torch/csrc/fused_link.cu",
           "benchmarks/probe_fused_link.py:31", fused_link,
           ("fused_link", "fused_link_reduce")),
    # FAVOR+'s backward: no TPU kernel (scat_tpu/ops/pallas_favor.py:168
    # _favor_bwd is a vjp through jax ops); favor_bwd_q counts the q pass,
    # favor_bwd_kv the k, v pass beside it
    Kernel("favor_bwd", "cuda", "scat_tpu_torch/csrc/favor_bwd.cu",
           "none (scat_tpu/ops/pallas_favor.py:168 _favor_bwd, a vjp)",
           favor_bwd_q, ("favor_bwd",)),
]
FWD, BWD, STATS, APPLY, LINK, FAVOR_BWD = KERNELS


def reset_counts():
    for k in KERNELS:
        k.wrapper.launches = 0
    favor_bwd_kv.launches = 0


@contextlib.contextmanager
def patched(owner, name, value):
    """``owner.name`` is ``value`` inside the block."""
    old = getattr(owner, name)
    setattr(owner, name, value)
    try:
        yield
    finally:
        setattr(owner, name, old)


def card_line() -> str:
    return subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit",
         "--format=csv,noheader"], capture_output=True, text=True,
        check=True).stdout.strip()


def device_ms(fn, iters=200, stream=None) -> float:
    """Device time per call of ``fn`` in ms: ``iters`` calls captured in
    one CUDA graph, replayed, timed by CUDA events (no host launch cost
    between the calls).  ``stream``: warm up and capture there (an
    autograd backward runs on its forward's stream)."""
    side = stream or torch.cuda.Stream()
    side.wait_stream(torch.cuda.current_stream())
    with torch.cuda.stream(side):
        for _ in range(3):
            fn()
    torch.cuda.current_stream().wait_stream(side)
    graph = torch.cuda.CUDAGraph()
    with torch.cuda.graph(graph, stream=stream):
        for _ in range(iters):
            fn()
    graph.replay()
    start = torch.cuda.Event(enable_timing=True)
    end = torch.cuda.Event(enable_timing=True)
    torch.cuda.synchronize()
    start.record()
    graph.replay()
    end.record()
    end.synchronize()
    return start.elapsed_time(end) / iters


def qkv_views(b, h, n, d, dtype, seed):
    """q, k, v as the transformer passes them: strided [B,H,N,D] views
    of one [B,N,3,H,D] projection output."""
    g = torch.Generator().manual_seed(seed)
    qkv = torch.randn(b, n, 3, h, d, generator=g).to("cuda", dtype)
    return qkv.permute(2, 0, 3, 1, 4)


# the kernels on the tensor cores, (source, kernel): their registers,
# shared memory and spills are printed at build
PTXAS_KERNELS = (("attention_fwd", "attention_fwd_bf16_kernel"),
                 ("attention_fwd", "attention_fwd_wgmma_kernel"),
                 ("attention_bwd", "attention_bwd_bf16_kernel"),
                 ("attention_bwd", "attention_bwd_wgmma_kernel"),
                 ("favor", "favor_stats_wgmma_kernel"),
                 ("favor", "favor_apply_bf16_kernel"),
                 ("favor_bwd", "favor_bwd_q_bf16_kernel"),
                 ("favor_bwd", "favor_bwd_kv_bf16_kernel"),
                 ("fused_link", "fused_link_kernel"))
# the wgmma kernels fed by TMA, whose accumulators a spill would stall
NO_SPILL_KERNELS = ("attention_fwd_wgmma_kernel",
                    "attention_bwd_wgmma_kernel", "favor_stats_wgmma_kernel",
                    "fused_link_kernel")
# the persistent kernels' sequence lengths (64 < N <= 128)
WGMMA_SEQS = (65, 80, 97, 100, 127, 128)


def ptxas_registers(name, kernel):
    """What ptxas said of ``kernel``'s registers, where this process
    built library ``name``."""
    lines = ptxas_lines(build.LOGS.get(name, ""), kernel)
    return next((line.split(":", 1)[1].strip() for line in lines
                 if "registers" in line), "loaded as built before")


def ptxas_lines(log, kernel):
    """The lines of ``nvcc -Xptxas -v`` output about each instantiation
    of ``kernel``: from its "Compiling entry function" line to the next
    entry."""
    out, keep = [], False
    for line in log.splitlines():
        if "Compiling entry function" in line:
            keep = kernel in line
        if keep and line.strip():
            out.append(line.strip())
    return out


def phase_build():
    t0 = time.perf_counter()
    compiled = build.build_all()
    for name in build.SOURCES:
        print(f"[build] {name}: {build.library_path(name)}")
    print(f"[build] {compiled} source(s) compiled in "
          f"{time.perf_counter() - t0:.1f} s")
    for name, kernel in PTXAS_KERNELS:
        if name not in build.LOGS:
            print(f"[build] {name}: loaded as built before, no ptxas output")
            continue
        lines = ptxas_lines(build.LOGS[name], kernel)
        assert lines, f"no ptxas output for {kernel}"
        for line in lines:
            print(f"[build] ptxas {kernel}: {line}")
        if kernel in NO_SPILL_KERNELS:
            assert any("0 bytes spill stores, 0 bytes spill loads" in line
                       for line in lines), f"{kernel} spills"
    print(f"[build] card: {card_line()}; torch {torch.__version__}, "
          f"CUDA {torch.version.cuda}")


def grad_out(b, h, n, d, dtype, seed):
    """dO as autograd delivers it after the merge of heads: [B,N,H,D]
    storage seen as [B,H,N,D]."""
    g = torch.Generator().manual_seed(seed)
    do = torch.randn(b, n, h, d, generator=g).to("cuda", dtype)
    return do.permute(0, 2, 1, 3)


def bound(n_bytes, flops, dtype=torch.bfloat16):
    """(ms, what bounds it): the larger of bytes over the memory rate
    and flops over the card's peak for ``dtype`` (bf16: the tensor
    cores; float32: the non-tensor-core rate)."""
    t_bytes = n_bytes / HBM_BYTES_PER_S * 1e3
    t_ops = flops / PEAK_FLOPS[dtype] * 1e3
    return max(t_bytes, t_ops), "bytes" if t_bytes >= t_ops else "operations"


def phase_kernels():
    buckets = [1, 2, 4, 7, 8, 16, 32, 64, TRAIN_BATCH]
    shapes = [(b, HEADS, TOKENS, HEAD_DIM) for b in buckets]
    shapes += [(2, 4, 128, HEAD_DIM), (3, 2, TOKENS, HEAD_DIM),
               (TRAIN_BATCH, HEADS, HEAD_TOKENS, HEAD_DIM)]
    train_shape = (TRAIN_BATCH, HEADS, TOKENS, HEAD_DIM)
    for i, shape in enumerate(shapes):
        for dtype, tol in ((torch.float32, 2e-5), (torch.bfloat16, 1e-2)):
            rtol = tol if dtype == torch.bfloat16 else 0
            q, k, v = qkv_views(*shape, dtype, seed=i)
            do = grad_out(*shape, dtype, seed=1000 + i)
            with torch.no_grad():
                got = flash_attention(q, k, v, SCALE)
            dgot = attention_bwd(q, k, v, do, SCALE)
            torch.cuda.synchronize()
            want = attention_reference(q.float(), k.float(), v.float(),
                                       SCALE)
            dwant = attention_bwd_reference(q.float(), k.float(), v.float(),
                                            do.float(), SCALE)
            err = (got.float() - want).abs().max().item()
            derr = max((a.float() - b).abs().max().item()
                       for a, b in zip(dgot, dwant))
            torch.testing.assert_close(got.float(), want, atol=tol,
                                       rtol=rtol)
            for name, a, b in zip(("dq", "dk", "dv"), dgot, dwant):
                assert a.dtype == dtype, (name, a.dtype)
                torch.testing.assert_close(a.float(), b, atol=tol,
                                           rtol=rtol, msg=name)
            ulps = ""
            if dtype == torch.bfloat16:
                # P (and dS) split into bf16 high and low parts: within 2
                # bf16 ulps of the float32 plain version rounded to bf16
                u = [bf16_ulps(a, b).max().item()
                     for a, b in zip((got, *dgot), (want, *dwant))]
                assert max(u) <= ULPS, u
                ulps = (f"; bf16 ulps from the float32 plain version "
                        f"(o, dq, dk, dv) {', '.join(f'{x:g}' for x in u)} "
                        f"(bound {ULPS})")
            print(f"[kernels] {list(shape)} {str(dtype)[6:]}: attention_fwd "
                  f"max_abs_err {err:.3e}, attention_bwd max_abs_err "
                  f"{derr:.3e} (tol {tol}){ulps}")
            if shape == train_shape and dtype == torch.bfloat16:
                FWD.result["max_abs_err"] = err
                BWD.result["max_abs_err"] = derr
                print(f"[kernels] bf16 attention_fwd gap to the plain path at "
                      f"the training shape {err:.3e} (P rounded to bf16: "
                      f"{ROUNDED_P_FWD_GAP:.2e})")
                assert err < ROUNDED_P_FWD_GAP, err

    # the autograd.Function against autograd through the plain version,
    # float32, on the strided views the model passes
    for i, shape in enumerate([train_shape, (2, 4, 128, HEAD_DIM)]):
        views = qkv_views(*shape, torch.float32, seed=50 + i)
        leaves = [t.detach().requires_grad_(True) for t in views]
        do = grad_out(*shape, torch.float32, seed=60 + i)
        got = torch.autograd.grad(flash_attention(*leaves, SCALE), leaves,
                                  do)
        want = torch.autograd.grad(attention_reference(*leaves, SCALE),
                                   leaves, do)
        err = max((a - b).abs().max().item() for a, b in zip(got, want))
        for a, b in zip(got, want):
            torch.testing.assert_close(a, b, atol=2e-5, rtol=0)
        print(f"[kernels] flash_attention autograd {list(shape)} float32 "
              f"vs autograd through attention_reference: max_abs_err "
              f"{err:.3e} (tol 2e-05)")

    # the persistent wgmma kernels across their N range, and at pair counts
    # that are not a multiple of their grid (one block an SM): each plan
    # against the library's, the backward twice (bit for bit the same)
    sms = torch.cuda.get_device_properties(0).multi_processor_count
    for b, h, n in [(4, HEADS, n) for n in WGMMA_SEQS] + [
            (1, 1, 128), (7, 8, 100), (133, 1, 128), (265, 1, 97),
            (67, 4, 128)]:
        for dtype, tol in ((torch.float32, 2e-5), (torch.bfloat16, 1e-2)):
            rtol = tol if dtype == torch.bfloat16 else 0
            plan = forward_plan(n, dtype, b * h, sms)
            assert kernel_plan(n, dtype, b * h, sms) == plan, plan
            bplan = backward_plan(n, dtype, b * h, sms)
            assert kernel_plan(n, dtype, b * h, sms,
                               name="attention_bwd") == bplan, bplan
            q, k, v = qkv_views(b, h, n, HEAD_DIM, dtype, seed=700 + n + b)
            do = grad_out(b, h, n, HEAD_DIM, dtype, seed=800 + n + b)
            with torch.no_grad():
                got = flash_attention(q, k, v, SCALE)
            dgot = attention_bwd(q, k, v, do, SCALE)
            again = attention_bwd(q, k, v, do, SCALE)
            torch.cuda.synchronize()
            assert all(torch.equal(a, c) for a, c in zip(dgot, again)), \
                "attention_bwd differs between two launches"
            want = attention_reference(q.float(), k.float(), v.float(),
                                       SCALE)
            dwant = attention_bwd_reference(q.float(), k.float(), v.float(),
                                            do.float(), SCALE)
            err = (got.float() - want).abs().max().item()
            derr = max((a.float() - w).abs().max().item()
                       for a, w in zip(dgot, dwant))
            torch.testing.assert_close(got.float(), want, atol=tol,
                                       rtol=rtol)
            for name, a, w in zip(("dq", "dk", "dv"), dgot, dwant):
                torch.testing.assert_close(a.float(), w, atol=tol, rtol=rtol,
                                           msg=name)
            ulps = ""
            if dtype == torch.bfloat16:
                u = [bf16_ulps(a, w).max().item()
                     for a, w in zip((got, *dgot), (want, *dwant))]
                assert max(u) <= ULPS, u
                ulps = (f", bf16 ulps (o, dq, dk, dv) "
                        f"{', '.join(f'{x:g}' for x in u)} (bound {ULPS})")
            print(f"[kernels] [{b},{h},{n},{HEAD_DIM}] {str(dtype)[6:]}: "
                  f"attention_fwd {plan[0]} on {plan[1]} blocks, max_abs_err "
                  f"{err:.3e}; attention_bwd {bplan[0]} on {bplan[1]} blocks "
                  f"(the library's plan alike), max_abs_err {derr:.3e}, two "
                  f"launches equal (tol {tol}){ulps}")

    print("[kernels] device times in ms, bf16, q/k/v strided views as in "
          "the model; 200 calls in one CUDA graph, timed by CUDA events:")
    for b in (1, 7, 64, TRAIN_BATCH):
        got = time_fwd(b, TOKENS)
        if b == TRAIN_BATCH:
            FWD.result.update(got)
    BWD.result.update(time_bwd(TRAIN_BATCH, TOKENS))

    # the 128-token heads' shape (HRNet and Inception, 8 heads): the
    # persistent wgmma kernels of both directions
    card = card_line()
    for n in (TOKENS, HEAD_TOKENS):
        for name in ("attention_fwd", "attention_bwd"):
            for dtype in (torch.float32, torch.bfloat16):
                blocks, smem = attention_occupancy(name, n, dtype)
                print(f"[kernels] {name} N={n} {str(dtype)[6:]}: {blocks} "
                      f"block(s) an SM at once (occupancy API), {smem} B of "
                      f"shared memory a block")
    for name in ("attention_fwd", "attention_bwd"):
        blocks, smem = attention_occupancy(name, HEAD_TOKENS, torch.bfloat16)
        assert blocks >= 1, (name, blocks)
        plan = (forward_plan if name == "attention_fwd" else backward_plan)(
            HEAD_TOKENS, torch.bfloat16, TRAIN_BATCH * HEADS, sms)
        assert kernel_plan(HEAD_TOKENS, torch.bfloat16, TRAIN_BATCH * HEADS,
                           sms, name=name) == plan, (name, plan)
        print(f"[kernels] {name} at N={HEAD_TOKENS} bf16: {plan[0]}, a "
              f"persistent grid of {plan[1]} blocks over "
              f"{TRAIN_BATCH * HEADS} pairs, the library's plan alike "
              f"({blocks} block(s) an SM, {smem} B of shared memory, ptxas: "
              f"{ptxas_registers(name, f'{name}_wgmma_kernel')})")
    fwd = time_fwd(TRAIN_BATCH, HEAD_TOKENS)
    FWD.result.update(ms_n128=fwd["ms"], bound_ms_n128=fwd["bound_ms"],
                      library_ms_n128=fwd["library_ms"])
    bwd = time_bwd(TRAIN_BATCH, HEAD_TOKENS)
    BWD.result.update(ms_n128=bwd["ms"], bound_ms_n128=bwd["bound_ms"],
                      library_ms_n128=bwd["library_ms"])
    print(f"[kernels] at [{TRAIN_BATCH},{HEADS},{HEAD_TOKENS},{HEAD_DIM}] "
          f"bf16: attention_fwd {fwd['ms']:.5f} ms, bound "
          f"{fwd['bound_ms']:.6f} ({100 * fwd['bound_ms'] / fwd['ms']:.1f}% "
          f"of it), SDPA {fwd['library_ms']:.5f}; attention_bwd "
          f"{bwd['ms']:.5f} ms, bound {bwd['bound_ms']:.6f} "
          f"({100 * bwd['bound_ms'] / bwd['ms']:.1f}%), SDPA's backward "
          f"alone {bwd['library_ms']:.5f}; forward+backward: the kernels' "
          f"{bwd['pair_ms']:.5f}, SDPA's {bwd['sdpa_pair_ms']:.5f}; card "
          f"{card}")


def time_fwd(b, n):
    """The forward kernel at [b, 8, n, 64] beside the plain version and
    SDPA, and its bound; the kernels line's keys."""
    q, k, v = qkv_views(b, HEADS, n, HEAD_DIM, torch.bfloat16, seed=100 + b)
    calls = {
        "kernel": lambda: flash_attention(q, k, v, SCALE),
        "plain": lambda: attention_reference(q, k, v, SCALE),
        "sdpa": lambda: F.scaled_dot_product_attention(q, k, v, scale=SCALE)}
    with torch.no_grad():
        dev = {name: device_ms(fn) for name, fn in calls.items()}
    n_bytes = 4 * b * HEADS * n * HEAD_DIM * 2
    flops = 4 * b * HEADS * n * n * HEAD_DIM
    ms, by = bound(n_bytes, flops)
    print(f"[kernels] attention_fwd b={b:2d} [{b},{HEADS},{n},{HEAD_DIM}]: "
          f"kernel {dev['kernel']:.5f} plain {dev['plain']:.5f} sdpa "
          f"{dev['sdpa']:.5f} | bound {ms:.6f} ({by}: {n_bytes} B, {flops} "
          f"flop) | {100 * ms / dev['kernel']:.1f}% of the bound")
    return dict(ms=dev["kernel"], plain_ms=dev["plain"],
                library_ms=dev["sdpa"], bound_ms=ms, bound_by=by)


def time_bwd(b, n):
    """The backward kernel at [b, 8, n, 64] beside the plain version and
    the library yardstick, SDPA's backward alone: autograd through one
    saved SDPA forward, the backward alone captured; and the
    forward+backward pairs, the kernels' and SDPA's."""
    q, k, v = qkv_views(b, HEADS, n, HEAD_DIM, torch.bfloat16, seed=7)
    do = grad_out(b, HEADS, n, HEAD_DIM, torch.bfloat16, seed=8)
    leaves = [t.detach().requires_grad_(True) for t in (q, k, v)]
    dev = {
        "kernel": device_ms(lambda: attention_bwd(q, k, v, do, SCALE)),
        "plain": device_ms(
            lambda: attention_bwd_reference(q, k, v, do, SCALE)),
        "kernels fwd+bwd": device_ms(lambda: torch.autograd.grad(
            flash_attention(*leaves, SCALE), leaves, do)),
        "sdpa fwd+bwd": device_ms(lambda: torch.autograd.grad(
            F.scaled_dot_product_attention(*leaves, scale=SCALE), leaves,
            do))}
    # the saved forward runs on the stream the backward is captured on
    side = torch.cuda.Stream()
    side.wait_stream(torch.cuda.current_stream())
    with torch.cuda.stream(side):
        out = F.scaled_dot_product_attention(*leaves, scale=SCALE)
    dev["sdpa bwd"] = device_ms(lambda: torch.autograd.grad(
        out, leaves, do, retain_graph=True), stream=side)
    n_bytes = 7 * b * HEADS * n * HEAD_DIM * 2
    flops = 10 * b * HEADS * n * n * HEAD_DIM
    ms, by = bound(n_bytes, flops)
    print(f"[kernels] attention_bwd b={b} [{b},{HEADS},{n},{HEAD_DIM}]: "
          f"kernel {dev['kernel']:.5f} plain {dev['plain']:.5f} sdpa bwd "
          f"{dev['sdpa bwd']:.5f} | kernels fwd+bwd "
          f"{dev['kernels fwd+bwd']:.5f} sdpa fwd+bwd "
          f"{dev['sdpa fwd+bwd']:.5f} | bound {ms:.6f} ({by}: {n_bytes} B, "
          f"{flops} flop) | {100 * ms / dev['kernel']:.1f}% of the bound")
    return dict(ms=dev["kernel"], plain_ms=dev["plain"],
                library_ms=dev["sdpa bwd"], bound_ms=ms, bound_by=by,
                pair_ms=dev["kernels fwd+bwd"],
                sdpa_pair_ms=dev["sdpa fwd+bwd"])


# the probe's five shapes (benchmarks/probe_fused_link.py:112-118): the
# bottleneck 1x1 links of ResNet-50 at bs 96, (M, K, N), and the
# flagship's links of each
LINK_SHAPES = [
    ((TRAIN_BATCH * 56 * 56, 256, 64), "layer1.{1,2} conv1"),
    ((TRAIN_BATCH * 56 * 56, 64, 256), "layer1.* bn2 -> conv3"),
    ((TRAIN_BATCH * 28 * 28, 512, 128), "layer2.{1..3} conv1"),
    ((TRAIN_BATCH * 28 * 28, 128, 512), "layer2.* bn2 -> conv3"),
    ((TRAIN_BATCH * 14 * 14, 1024, 256), "layer3.{1..5} conv1")]
# M that are not whole 128-row tiles (one row; a tile and a row; bs 1's
# layer1 links; layer4's at bs 96) and N = 1024 (layer3's conv3)
LINK_TAILS = [(1, 256, 64), (129, 64, 256), (56 * 56, 64, 256),
              (TRAIN_BATCH * 7 * 7, 2048, 512),
              (TRAIN_BATCH * 7 * 7, 512, 2048),
              (TRAIN_BATCH * 14 * 14, 256, 1024)]
# the probe's decision gate (benchmarks/probe_fused_link.py:12-13): the
# fused link must beat the decomposed chain by more than 20%
LINK_GATE = 1.2
# the flagship's links hooked in the link phase: (block, link), where the
# link "conv3" is bn2 -> relu -> conv3 (x bn2's input, bn2 folded into
# scale and shift) and "conv1" the block's post-ReLU input -> conv1 (scale
# 1, shift 0); each is one of the probe's shapes
FLAGSHIP_LINKS = [("layer1.0", "conv3"), ("layer1.1", "conv1"),
                  ("layer2.0", "conv3"), ("layer2.1", "conv1"),
                  ("layer3.1", "conv1")]


def link_operands(m, k, n, seed):
    """x [M, K] (about 0.5) and w [K, N] (fan-in scaled) bf16 and a folded
    BatchNorm's scale (about 1) and shift (about 0) [K] float32, drawn on
    the card from ``seed``."""
    g = torch.Generator("cuda").manual_seed(seed)
    draw = lambda *shape: torch.randn(*shape, generator=g,  # noqa: E731
                                      device="cuda")
    return ((draw(m, k) * 0.5).bfloat16(), (draw(k, n) / k ** 0.5).bfloat16(),
            1 + 0.2 * draw(k), 0.1 * draw(k))


def unfused_link(x, w, scale, shift):
    """The probe's comparison (xla_link, benchmarks/probe_fused_link.py:
    85-91) in eager PyTorch on the card: the prologue in float32, cuBLAS's
    bf16 product, the statistics as two reductions of the rounded y."""
    xn = torch.addcmul(shift, x, scale).relu_().bfloat16()
    y = xn @ w
    yf = y.float()
    return y, yf.sum(dim=0), yf.square().sum(dim=0)


def flagship_link_inputs():
    """The flagship's resnet50 at full width in train mode (bf16 autocast
    over float32 parameters, channels_last, seed 0) on a synthetic batch
    of 96: for each of ``FLAGSHIP_LINKS`` its x as [M, K] rows (the view
    of the channels_last map), scale and shift, w [K, N], and the module
    chain's conv output as rows, all taken by forward hooks."""
    model, _ = build_model(TRAIN, IMAGE)
    checkpoint.load_weights(model, "", seed=TRAIN.seed)
    model = model.to("cuda", memory_format=torch.channels_last).train()
    model.set_compute_dtype(compute_dtype(TRAIN))
    seen, hooks = {}, []
    for block_name, link in FLAGSHIP_LINKS:
        block = model.main_encoder.get_submodule(block_name)
        first, out = ((block.bn2, block.bn3) if link == "conv3" else
                      (block, block.bn1))

        def keep(key):
            return lambda _, args: seen.__setitem__(key, args[0])
        hooks += [first.register_forward_pre_hook(keep((block_name, "x"))),
                  out.register_forward_pre_hook(keep((block_name, "y")))]
    batch = next(iter(make_dataset(TRAIN, IMAGE, device="cuda")))
    with torch.no_grad():
        model(batch["image"].permute(0, 3, 1, 2))
    for h in hooks:
        h.remove()
    links = {}
    for block_name, link in FLAGSHIP_LINKS:
        block = model.main_encoder.get_submodule(block_name)
        x, y = seen[(block_name, "x")], seen[(block_name, "y")]
        assert x.dtype == y.dtype == torch.bfloat16, (x.dtype, y.dtype)
        assert x.is_contiguous(memory_format=torch.channels_last)
        rows = x.permute(0, 2, 3, 1).reshape(-1, x.shape[1])
        assert rows.data_ptr() == x.data_ptr(), "rows are not a view"
        conv = getattr(block, link)
        if link == "conv3":
            var, mean = torch.var_mean(x.double(), dim=(0, 2, 3),
                                       correction=0)
            scale = block.bn2.weight.double() / torch.sqrt(
                var + block.bn2.eps)
            shift = block.bn2.bias.double() - mean * scale
            scale, shift = scale.float().detach(), shift.float().detach()
        else:
            scale = torch.ones(x.shape[1], device="cuda")
            shift = torch.zeros(x.shape[1], device="cuda")
        w = conv.weight.detach().bfloat16()[:, :, 0, 0].t().contiguous()
        links[f"{block_name} {'bn2 -> conv3' if link == 'conv3' else link}"] \
            = (rows, w, scale, shift,
               y.permute(0, 2, 3, 1).reshape(-1, y.shape[1]))
    return links


def link_traffic(plan, m, k, n):
    """Bytes a plan moves through the L2 (MB): x read once a range, w's
    [K x bn] slice once a block where resident, else once for each group
    of a block's tiles, y written once."""
    slice_bytes = -(-k // 64) * 64 * plan.bn * 2
    if plan.resident:
        w_bytes = plan.grid * slice_bytes
    else:
        tiles = [-(-(plan.m_tiles - q) // plan.per_range)
                 for q in range(plan.per_range)]
        w_bytes = plan.ranges * slice_bytes * sum(
            -(-t // plan.groups) for t in tiles)
    return (plan.ranges * m * k * 2 + w_bytes + m * n * 2) / 1e6


def link_plan_line(m, k, n):
    """The plan of [m, k, n], its L2 traffic, and what ptxas said of the
    kernel it launches (registers, spills)."""
    plan = link_plan(m, k, n, torch.cuda.get_device_properties(
        0).multi_processor_count)
    smem = fused_link_op._library().scat_fused_link_smem(
        k, plan.bn, plan.groups, int(plan.resident), plan.stages)
    assert smem == plan.smem, (smem, plan)
    name = (f"fused_link_kernelILi{plan.bn}ELi{int(plan.resident)}"
            f"ELi{plan.groups}E")
    lines = ptxas_lines(build.LOGS.get("fused_link", ""), name)
    regs = next((line.split(":", 1)[1].strip() for line in lines
                 if "registers" in line), "loaded as built before")
    spills = next((line for line in lines if "spill" in line), "")
    return (f"tile 64x{plan.bn}, {plan.groups} consumer warpgroups, "
            f"{plan.grid} blocks ({plan.ranges} range(s) x "
            f"{plan.per_range}), {plan.rounds} M-tiles the busiest block, "
            f"{100 * plan.fill:.1f}% of the block slots busy, w "
            f"{'resident' if plan.resident else 'streamed'}, "
            f"{plan.stages} stages, {plan.smem} B of shared memory, "
            f"{link_traffic(plan, m, k, n):.1f} MB through the L2; ptxas: "
            f"{regs}; {spills}")


def phase_link():
    card = card_line()
    # the kernel against its plain version on the same bf16 inputs; at the
    # probe's shapes also a CUDA-graph replay of one call
    cases = [shape for shape, _ in LINK_SHAPES] + LINK_TAILS
    for i, (m, k, n) in enumerate(cases):
        x, w, scale, shift = link_operands(m, k, n, seed=900 + i)
        got = fused_link(x, w, scale, shift)
        again = fused_link(x, w, scale, shift)
        torch.cuda.synchronize()
        want = fused_link_reference(x, w, scale, shift)
        gaps = link_gaps(got, want, x, w, scale, shift)
        same = all(torch.equal(a, b) for a, b in zip(got, again))
        replay = "-"
        if i < len(LINK_SHAPES):
            graph = torch.cuda.CUDAGraph()
            with torch.cuda.graph(graph):
                captured = fused_link(x, w, scale, shift)
            graph.replay()
            torch.cuda.synchronize()
            replay = all(torch.equal(a, b) for a, b in zip(captured, got))
            assert replay, f"fused_link's graph replay differs at {m, k, n}"
            del graph, captured
        err = (got[0].float() - want[0].float()).abs().max().item()
        print(f"[link] [{m},{k},{n}]: y max_abs_err {err:.3e} ({gaps['y']:g} "
              f"bf16 ulp at max|y|), s at {gaps['s']:.3f} and ss at "
              f"{gaps['ss']:.3f} of their bounds, against the plain version "
              f"in float32; two launches {'equal' if same else 'DIFFER'}, "
              f"a graph replay equal: {replay}")
        print(f"[link] [{m},{k},{n}] plan: {link_plan_line(m, k, n)}")
        assert max(gaps.values()) <= 1, ((m, k, n), gaps)
        assert same, f"fused_link differs between two launches at {m, k, n}"
        if i == 0:
            LINK.result["max_abs_err"] = err
        del x, w, got, again, want

    # the flagship's own links: the kernel on the hooked inputs against
    # the module chain (conv(relu(bn2(x))), the next BatchNorm's batch
    # statistics as sums) and the plain version; these launches are the
    # kernel's counted run
    links = flagship_link_inputs()
    fused_link.launches = 0
    outs = {name: fused_link(*args[:4]) for name, args in links.items()}
    torch.cuda.synchronize()
    launches = fused_link.launches
    assert launches == len(links), launches
    LINK.result["launches"] += launches
    tiny = torch.finfo(torch.float64).tiny
    for name, (x, w, scale, shift, chain) in links.items():
        y, s, ss = outs[name]
        shape = (x.shape[0], x.shape[1], w.shape[1])
        assert shape in [sh for sh, _ in LINK_SHAPES], (name, shape)
        gaps = link_gaps(outs[name], fused_link_reference(x, w, scale, shift),
                         x, w, scale, shift)
        assert max(gaps.values()) <= 1, (name, gaps)
        # the next BatchNorm's batch statistics as sums: of the chain's
        # bf16 y, where the kernel's s and ss are of its float32 product
        # before rounding, so they differ by up to y's rounding, |acc -
        # y| <= ulp(y) / 2 a row
        cf, yk = chain.double(), y.double()
        c_s, c_ss, c_abs = cf.sum(0), cf.square().sum(0), cf.abs().sum(0)
        ulp = torch.exp2(torch.floor(torch.log2(yk.abs().clamp(min=tiny)))
                         - 7)
        round_s = (ulp / 2).sum(0)
        round_ss = ((2 * yk.abs() + ulp / 2) * ulp / 2).sum(0)
        y_gap = ((yk - cf).abs().max() / cf.abs().max()).item()
        ys_gap = max(((yk.sum(0) - c_s).abs() / c_abs).max().item(),
                     ((yk.square().sum(0) - c_ss).abs() / c_ss).max().item())
        s_gap = ((s.double() - c_s).abs() / c_abs).max().item()
        ss_gap = ((ss.double() - c_ss).abs() / c_ss).max().item()
        s_share = ((s.double() - c_s).abs()
                   / (1e-3 * c_abs + round_s)).max().item()
        ss_share = ((ss.double() - c_ss).abs()
                    / (1e-3 * c_ss + round_ss)).max().item()
        print(f"[link] flagship {name} {list(shape)}: y within {y_gap:.3e} of "
              f"the module chain's largest |y| (bound {BF16_REL}); the next "
              f"BatchNorm's batch statistics as sums against those of the "
              f"kernel's y {ys_gap:.3e} (bound 1e-3), against its s "
              f"{s_gap:.3e} of the column's sum of |y| and ss {ss_gap:.3e} "
              f"relative, at {s_share:.3f} and {ss_share:.3f} of 1e-3 plus "
              f"y's rounding; against the plain version on the same inputs: "
              f"y {gaps['y']:g} ulp, s and ss at {gaps['s']:.3f} and "
              f"{gaps['ss']:.3f} of their bounds")
        assert y_gap <= BF16_REL and ys_gap <= 1e-3, (name, y_gap, ys_gap)
        assert s_share <= 1 and ss_share <= 1, (name, s_share, ss_share)
    print(f"[link] fused_link launches on the flagship's links {launches}")
    del links, outs

    print(f"[link] device times in ms, bf16 x [M, K] and w [K, N], float32 "
          f"scale and shift; 20 calls in one CUDA graph, timed by CUDA "
          f"events; card {card}:")
    for i, ((m, k, n), what) in enumerate(LINK_SHAPES):
        x, w, scale, shift = link_operands(m, k, n, seed=950 + i)
        xn = torch.addcmul(shift, x, scale).relu_().bfloat16()
        calls = {
            "kernel": lambda: fused_link(x, w, scale, shift),
            "plain": lambda: fused_link_reference(x, w, scale, shift),
            "chain": lambda: unfused_link(x, w, scale, shift),
            "cublas": lambda: xn @ w}
        with torch.no_grad():
            dev = {name: device_ms(fn, iters=20) for name, fn in calls.items()}
        # x, w and y once, scale and shift, s and ss
        n_bytes = 2 * (m * k + k * n + m * n) + 4 * (2 * k + 2 * n)
        flops = 2 * m * k * n
        ms, by = bound(n_bytes, flops)
        print(f"[link] shape {i + 1} [{m},{k},{n}] ({what}): kernel "
              f"{dev['kernel']:.5f} plain {dev['plain']:.5f} chain "
              f"{dev['chain']:.5f} | bound {ms:.6f} ({by}: {n_bytes} B, "
              f"{flops} flop) | {100 * ms / dev['kernel']:.1f}% of the bound "
              f"| card {card}")
        ratio = dev["chain"] / dev["kernel"]
        print(f"[link] shape {i + 1}: cuBLAS's product alone on a ready xn "
              f"{dev['cublas']:.5f} ms ({100 * ms / dev['cublas']:.1f}% of "
              f"the link's bound); the gate, chain / kernel = {ratio:.2f} "
              f"against {LINK_GATE} "
              f"({'met' if ratio > LINK_GATE else 'not met'})")
        if i == 0:
            LINK.result.update(ms=dev["kernel"], plain_ms=dev["plain"],
                               bound_ms=ms, bound_by=by,
                               library_ms=dev["chain"])
        if i == len(LINK_SHAPES) - 1:
            link_cold_and_reduce(x, w, scale, shift, dev["kernel"], card)
        del x, w, scale, shift, xn, calls


def link_cold_and_reduce(x, w, scale, shift, warm_ms, card):
    """Layer3's shape once more with x rotated over three copies in the
    graph (its operands, 48.7 MB, about fill the 50 MB L2), and the
    second launch (the sum of the blocks' partials) timed alone."""
    (m, k), n = x.shape, w.shape[1]
    xs = [x, x.clone(), x.clone()]
    turn = [0]

    def rotated():
        fused_link(xs[turn[0] % 3], w, scale, shift)
        turn[0] += 1
    with torch.no_grad():
        cold = device_ms(rotated, iters=21)
    print(f"[link] shape {len(LINK_SHAPES)} [{m},{k},{n}] with x rotated over "
          f"3 copies in the graph: kernel {cold:.5f} ms (L2-warm "
          f"{warm_ms:.5f}) | card {card}")
    plan = link_plan(m, k, n, torch.cuda.get_device_properties(
        0).multi_processor_count)
    work = torch.rand(plan.workspace(n), device="cuda")
    s = torch.empty(n, device="cuda")
    ss = torch.empty(n, device="cuda")
    lib = fused_link_op._library()

    def reduce(dependent):
        def call():
            rc = lib.scat_fused_link_reduce(
                work.data_ptr(), s.data_ptr(), ss.data_ptr(),
                plan.per_range, n, dependent,
                torch.cuda.current_stream().cuda_stream)
            assert rc == 0, rc
        return call
    alone = device_ms(reduce(0), iters=20)
    dep = device_ms(reduce(1), iters=20)
    print(f"[link] the second launch (the sum of {plan.per_range} partial "
          f"rows of {n} columns) alone: {alone:.5f} ms a launch, "
          f"{dep:.5f} with programmatic stream serialisation after "
          f"itself, against the link's {warm_ms:.5f} | card {card}")
    del xs, work


def n_chunks(n: int, big: int) -> int:
    return -(-n // big)


def check_output(out, n, root_centred=True):
    """Shapes and finiteness; the flagship root-centres on joint 1, ViP
    does not."""
    assert out["camera"].shape == (n, 3), out["camera"].shape
    assert out["joints_3d"].shape == (n, 21, 3), out["joints_3d"].shape
    assert out["joints_2d"].shape == (n, 21, 2), out["joints_2d"].shape
    for k, v in out.items():
        assert v.dtype == np.float32 and np.isfinite(v).all(), k
    if root_centred:
        assert np.all(out["joints_3d"][:, 1] == 0), "joint 1 is the root"


def phase_slice(rng):
    t0 = time.perf_counter()
    pred = HandPosePredictor.from_checkpoint(FLAGSHIP, image_size=IMAGE)
    model = pred.model
    assert model.main_encoder.fc1.in_features == 2048      # resnet50
    assert model.transformer.layers[0][0].fn.norm.normalized_shape \
        == ((IMAGE // 8) ** 2,)
    assert len(model.transformer.layers) == 3
    assert model.transformer.layers[0][0].fn.fn.to_qkv.weight.dtype \
        == torch.bfloat16
    assert model.main_encoder.bn1.running_var.dtype == torch.float32
    print(f"[slice] predictor built in {time.perf_counter() - t0:.1f} s "
          f"(resnet50, 224, 784-dim tokens, 8 heads, iteration 3, bf16); "
          f"buckets {pred._buckets}")
    t0 = time.perf_counter()
    pred.warmup()
    print(f"[slice] warmup of every bucket, uint8 and float32: "
          f"{time.perf_counter() - t0:.1f} s")

    crops = {n: rng.randint(0, 256, (n, IMAGE, IMAGE, 3)).astype(np.uint8)
             for n in REQUESTS}
    as_float = crops[7].astype(np.float32) / 127.5 - 1.0
    big = pred._buckets[-1]
    reset_counts()
    outs = {n: pred.predict(crops[n]) for n in REQUESTS}
    out_f = pred.predict(as_float)
    launches = flash_attention.launches
    chunks = sum(n_chunks(n, big) for n in REQUESTS) + n_chunks(7, big)
    FWD.result["launches"] += launches
    print(f"[slice] requests {list(REQUESTS)} uint8 + 7 float32: "
          f"{chunks} forward chunks, attention_fwd launches {launches}, "
          f"attention_bwd launches {attention_bwd.launches}")
    assert launches == 3 * chunks, (launches, chunks)
    assert attention_bwd.launches == 0, attention_bwd.launches
    for n, out in outs.items():
        check_output(out, n)
    check_output(out_f, 7)
    j = outs[64]["joints_3d"]
    print(f"[slice] outputs finite, root-centred; |joints_3d| max "
          f"{np.abs(j).max():.4f}, camera[0] {outs[64]['camera'][0]}")

    # (what, got, want, bound or None for BF16_REL * max|want|)
    pairs = [(f"bf16 float32 vs uint8 request, 7 crops, {k}", out_f[k],
              outs[7][k], None) for k in out_f]
    # the same weights (same seed) on the plain attention path
    plain = HandPosePredictor.from_checkpoint(
        dataclasses.replace(FLAGSHIP, use_pallas_attention=False),
        image_size=IMAGE)
    before = flash_attention.launches
    out_plain = plain.predict(crops[64])
    assert flash_attention.launches == before, "plain path launched"
    del plain
    pairs += [(f"bf16 kernel vs plain attention, 64 crops, {k}", outs[64][k],
               out_plain[k], None) for k in out_plain]
    f32 = dataclasses.replace(FLAGSHIP, compute_dtype="float32")
    p32 = HandPosePredictor.from_checkpoint(f32, image_size=IMAGE)
    o32 = p32.predict(crops[7])
    o32_float = p32.predict(as_float)
    del p32
    o32_plain = HandPosePredictor.from_checkpoint(
        dataclasses.replace(f32, use_pallas_attention=False),
        image_size=IMAGE).predict(crops[7])
    pairs += [("float32 kernel vs plain attention, 7 crops, joints_3d",
               o32["joints_3d"], o32_plain["joints_3d"], F32_ATOL),
              ("float32 float32 vs uint8 request, 7 crops, joints_3d",
               o32_float["joints_3d"], o32["joints_3d"], F32_ATOL)]
    compare("slice", pairs)

    # end to end: every crop of a window of back-to-back requests over
    # the window's wall time, on the pipelined serving path
    window = [rng.randint(0, 256, (WINDOW_CROPS, IMAGE, IMAGE, 3),
                          dtype=np.uint8) for _ in range(WINDOW_REQUESTS)]
    pred.predict(window[0])
    t0 = time.perf_counter()
    for x in window:
        pred.predict(x)
    dt = time.perf_counter() - t0
    n = WINDOW_REQUESTS * WINDOW_CROPS
    print(f"[slice] end to end: {WINDOW_REQUESTS} back-to-back requests of "
          f"{WINDOW_CROPS} uint8 crops (chunks of {big}), {n} crops in "
          f"{dt * 1e3:.1f} ms: {n / dt:.1f} crops/s")
    del window

    print("[slice] per bucket (uint8, 20 requests each): p50 request "
          "latency (host clock, pipelined path)")
    for b in pred._buckets:
        x = rng.randint(0, 256, (b, IMAGE, IMAGE, 3), dtype=np.uint8)
        req_t = []
        for _ in range(20):
            t0 = time.perf_counter()
            pred.predict(x)
            req_t.append(time.perf_counter() - t0)
        print(f"[slice] bucket {b:2d}: p50 request "
              f"{np.median(req_t) * 1e3:.3f} ms")
    return pred, crops


def device_profile(tag, fn, what, check=None):
    """torch.profiler over ``fn()`` (which ends in a synchronize): wall
    time, the device's busy and idle share of it, each hand-written
    kernel's share of device time, and the top device operations (one
    stream, so kernel times add up).  ``check``, if given, is called with
    every event of ``key_averages()`` (host and device).  Returns the
    busy time in ms and its share of the wall time in percent."""
    acts = [torch.profiler.ProfilerActivity.CPU,
            torch.profiler.ProfilerActivity.CUDA]
    with torch.profiler.profile(activities=acts) as prof:
        t0 = time.perf_counter()
        fn()
        wall_us = (time.perf_counter() - t0) * 1e6
    # device-side events only (kernels, copies): the aten ops that launch
    # them carry the same time again, and so do the device-side ranges
    # of user annotations (the optimizer's step)
    events = [e for e in prof.key_averages()
              if e.device_type == torch.autograd.DeviceType.CUDA
              and e.self_device_time_total > 0
              and not getattr(e, "is_user_annotation", False)]
    if check is not None:
        check(list(prof.key_averages()))
    busy = sum(e.self_device_time_total for e in events)
    busy_pct = 100 * busy / wall_us
    shares = []
    for k in KERNELS:
        t = sum(e.self_device_time_total for e in events
                if any(key in e.key for key in k.profile_keys))
        shares.append(f"{k.name} {t / 1e3:.4f} ms "
                      f"({100 * t / max(busy, 1e-9):.2f}% of device time)")
    print(f"[{tag}] {what}: wall {wall_us / 1e3:.3f} ms, device busy "
          f"{busy / 1e3:.3f} ms ({busy_pct:.1f}%, idle "
          f"{100 - busy_pct:.1f}%), {', '.join(shares)}")
    family = {}
    for e in events:
        name = next((f for f, keys in PROFILE_FAMILIES
                     if any(key in e.key for key in keys)), "other")
        family[name] = family.get(name, 0) + e.self_device_time_total
    print(f"[{tag}] device time by family: " + ", ".join(
        f"{name} {100 * t / max(busy, 1e-9):.1f}%"
        for name, t in sorted(family.items(), key=lambda kv: -kv[1])))
    for e in sorted(events, key=lambda e: -e.self_device_time_total)[:12]:
        key = e.key.replace("void ", "").replace("at::native::", "").replace(
            "(anonymous namespace)::", "")
        print(f"[{tag}]   {e.self_device_time_total / 1e3:9.3f} ms "
              f"{100 * e.self_device_time_total / busy:5.1f}% "
              f"x{e.count:<5d} {key[:120]}")
    return busy / 1e3, busy_pct


def phase_profile(pred, rng):
    """Where a forward chunk's device time goes: one pipelined 256-crop
    request (4 chunks of 64)."""
    x = rng.randint(0, 256, (256, IMAGE, IMAGE, 3)).astype(np.uint8)
    pred.predict(x)
    device_profile("profile", lambda: pred.predict(x),
                   "256 crops in 4 chunks of 64")


def set_kernel(model, on: bool):
    for m in model.modules():
        if isinstance(m, Attention):
            m.use_kernel = on


def step_vs_plain(tag, model, batch):
    """One step's loss and global gradient norm through the attention
    kernels against the plain attention path, from the same weights,
    batch and token mask: within BF16_REL; 3 + 3 launches, none on the
    plain path."""
    flags = torch.zeros(21, dtype=torch.bool, device=batch["image"].device)
    flags[[0, 5, 9, 17]] = True

    def loss_and_grad_norm():
        model.zero_grad(set_to_none=True)
        bd = steps.forward_loss(model, batch["image"], batch["label"],
                                batch["valid"], TRAIN.l_weight_3d,
                                TRAIN.l_weight_2d, token_mask=flags)[0]
        bd.total.backward()
        norm = torch.sqrt(sum((p.grad.float() ** 2).sum()
                              for p in model.parameters()
                              if p.grad is not None))
        return bd.total.item(), norm.item()

    reset_counts()
    loss_k, norm_k = loss_and_grad_norm()
    assert flash_attention.launches == 3 and attention_bwd.launches == 3
    set_kernel(model, False)
    loss_p, norm_p = loss_and_grad_norm()
    assert flash_attention.launches == 3 and attention_bwd.launches == 3, \
        "plain path launched"
    set_kernel(model, True)
    model.zero_grad(set_to_none=True)
    failed = []
    for what, got, want in (("loss", loss_k, loss_p),
                            ("global gradient norm", norm_k, norm_p)):
        diff, bnd = abs(got - want), BF16_REL * abs(want)
        print(f"[{tag}] bf16 kernel vs plain attention, one step, {what}: "
              f"{got:.6g} vs {want:.6g}, diff {diff:.4e} (bound {bnd:.4e})")
        if not diff <= bnd:
            failed.append(what)
    assert not failed, failed


def phase_train(rng):
    t0 = time.perf_counter()
    trainer = Trainer(TRAIN, image_size=IMAGE)
    state, model = trainer.state, trainer.model
    assert model.main_encoder.fc1.in_features == 2048      # resnet50
    assert model.transformer.layers[0][0].fn.norm.normalized_shape \
        == ((IMAGE // 8) ** 2,)
    assert all(p.dtype == torch.float32 for p in model.parameters())
    assert model.compute_dtype == torch.bfloat16
    print(f"[train] trainer built in {time.perf_counter() - t0:.1f} s "
          f"(resnet50, bs {TRAIN.batch_size}, {IMAGE}x{IMAGE}, "
          f"{(IMAGE // 8) ** 2}-dim tokens, 8 heads, iteration 3, mask_rate "
          f"0.2, bf16 compute, float32 parameters)")
    log = os.path.join(TRAIN.checkpoint_folder, "metrics.csv")
    if os.path.exists(log):
        os.remove(log)
    n_steps = TRAIN.epoch * TRAIN.steps_per_epoch
    reset_counts()
    t0 = time.perf_counter()
    trainer.train()
    fwd, bwd = flash_attention.launches, attention_bwd.launches
    print(f"[train] {TRAIN.epoch} epochs x {TRAIN.steps_per_epoch} steps in "
          f"{time.perf_counter() - t0:.1f} s (first steps and saves "
          f"included); attention_fwd launches {fwd}, attention_bwd "
          f"launches {bwd}")
    FWD.result["launches"] += fwd
    BWD.result["launches"] += bwd
    assert fwd == 3 * n_steps and bwd == 3 * n_steps, (fwd, bwd, n_steps)
    with open(log) as f:
        losses = [float(r["loss"]) for r in csv.DictReader(f)]
    assert len(losses) == n_steps and np.isfinite(losses).all(), losses
    quarter = n_steps // 4
    first, last = np.mean(losses[:quarter]), np.mean(losses[-quarter:])
    print(f"[train] loss: mean of the first {quarter} steps {first:.1f}, "
          f"of the last {quarter} {last:.1f}")
    assert last < first, (first, last)

    batches = list(trainer.train_loader)[:2]
    batch = batches[0]
    step_vs_plain("train", model, batch)

    stats = steps.make_train_step(TRAIN.l_weight_3d, TRAIN.l_weight_2d,
                                  grad_accum=2)(state, batch)
    assert np.isfinite(stats["loss"].item())
    print(f"[train] grad_accum 2 step: loss {stats['loss'].item():.1f}")

    # the final checkpoint, served as it is: in bf16 it equals the trained
    # model cast to bf16; in float32 it agrees with the trained model's
    # float32 eval forward to the float32 bar
    path = checkpoint.save_state(TRAIN.checkpoint_folder, state,
                                 checkpoint.FINAL_NAME)
    crops = rng.randint(0, 256, (8, IMAGE, IMAGE, 3)).astype(np.uint8)
    served = HandPosePredictor.from_checkpoint(
        dataclasses.replace(TRAIN, checkpoint_path_eval=path),
        image_size=IMAGE)
    got = served.predict(crops)
    check_output(got, 8)
    mirror = HandPosePredictor(
        model=copy.deepcopy(model).cast_compute(torch.bfloat16),
        image_size=IMAGE)
    for k, v in mirror.predict(crops).items():
        np.testing.assert_array_equal(got[k], v, err_msg=k)
    del served, mirror
    got32 = HandPosePredictor.from_checkpoint(
        dataclasses.replace(TRAIN, checkpoint_path_eval=path,
                            compute_dtype="float32"),
        image_size=IMAGE).predict(crops)
    model.eval().set_compute_dtype(torch.float32)
    with torch.no_grad():
        x = torch.from_numpy(crops).cuda().float() / 127.5 - 1.0
        want = model(x.permute(0, 3, 1, 2))[0][:, 3:].reshape(-1, 21, 3)
    model.train().set_compute_dtype(torch.bfloat16)
    diff = float(np.abs(got32["joints_3d"] - want.cpu().numpy()).max())
    print(f"[train] {path} served by HandPosePredictor: bf16 predict equals "
          f"the trained model's; float32 predict vs the trained model's "
          f"float32 eval forward, joints_3d max abs diff {diff:.4e} (bound "
          f"{F32_ATOL})")
    assert diff <= F32_ATOL, diff

    ev = steps.make_eval_step(model)(batch)
    pck, err = ev["pck"].cpu().numpy(), ev["mpjpe_per_sample"].cpu().numpy()
    assert pck.shape == (7, 22) and ((pck >= 0) & (pck <= 100)).all()
    assert np.isfinite(err).all() and err.shape == (TRAIN.batch_size,)
    print(f"[train] eval step on a training batch: PA-MPJPE "
          f"{1e3 * err.mean():.2f} mm, PCK at 20..50 mm "
          f"{', '.join(f'{v:.2f}' for v in pck[:, -1])} %")

    train_flags()
    return train_rate("train", state, trainer.train_step, batches)


# the canonical flag line's --debug True (its default) with
# --profile_trace_dir and --tensorboard True: 5 steps, the trace window
# over steps 4 and 5
FLAGS_TRAIN = dataclasses.replace(
    TRAIN, debug=True, tensorboard=True, epoch=1, steps_per_epoch=5,
    profile_trace_dir=os.path.join("build", "chip_smoke_trace"),
    profile_trace_steps=2,
    checkpoint_folder=os.path.join("build", "chip_smoke_flags"))


def train_flags():
    """The Trainer with --debug True, --profile_trace_dir and
    --tensorboard True: the debug grid or matplotlib's skip message, a
    Chrome trace whose device kernels include both attention kernels,
    the events or tensorboardX's CSV-only message; 3 + 3 launches a
    step."""
    import io
    trace = os.path.join(FLAGS_TRAIN.profile_trace_dir, "trace.json")
    if os.path.exists(trace):
        os.remove(trace)
    reset_counts()
    out = io.StringIO()
    t0 = time.perf_counter()
    with contextlib.redirect_stdout(out):
        Trainer(FLAGS_TRAIN, image_size=IMAGE).train()
    dt = time.perf_counter() - t0
    text = out.getvalue()
    fwd, bwd = flash_attention.launches, attention_bwd.launches
    FWD.result["launches"] += fwd
    BWD.result["launches"] += bwd
    assert fwd == bwd == 3 * FLAGS_TRAIN.steps_per_epoch, (fwd, bwd)
    grid = os.path.join("debug_img",
                        f"debug_gt_pred_{FLAGS_TRAIN.debug_img}.png")
    skipped = "matplotlib unavailable, skipping the debug grid" in text
    assert "==== Visualize ====" in text and (skipped or
                                              os.path.exists(grid)), text
    csv_only = "tensorboardX is not installed; CSV only" in text
    events = os.path.join(FLAGS_TRAIN.checkpoint_folder, "tb", "metrics")
    assert csv_only or os.path.isdir(events), text
    with open(trace) as f:
        kernels = {e["name"] for e in json.load(f)["traceEvents"]
                   if e.get("cat") == "kernel"}
    named = {k: sorted(n for n in kernels if k in n)
             for k in ("attention_fwd", "attention_bwd")}
    assert all(named.values()), named
    print(f"[train] --debug True --profile_trace_dir --tensorboard True, "
          f"{FLAGS_TRAIN.steps_per_epoch} steps in {dt:.1f} s: debug grid "
          f"{'skipped, no matplotlib' if skipped else grid}; "
          f"{'CSV only, no tensorboardX' if csv_only else events}; "
          f"{trace}: {len(kernels)} device kernel names, of them "
          f"{[n[:40] for v in named.values() for n in v]}; launches "
          f"{fwd} + {bwd}")


def train_rate(tag, state, step, batches):
    """The training rate: a window of 20 steps after 3 warm-up steps,
    synchronised at its ends; the p50 of 10 steps, each synchronised; a
    profile of 3 steps, whose device time a step is held against the p50
    (the profiler slows the host)."""
    for i in range(3):
        step(state, batches[i % 2])
    torch.cuda.synchronize()
    window = 20
    t0 = time.perf_counter()
    for i in range(window):
        step(state, batches[i % 2])
    torch.cuda.synchronize()
    dt = time.perf_counter() - t0
    times = []
    for i in range(10):
        t1 = time.perf_counter()
        step(state, batches[i % 2])
        torch.cuda.synchronize()
        times.append(time.perf_counter() - t1)
    rate = window * TRAIN.batch_size / dt
    print(f"[{tag}] rate: {window} steps of {TRAIN.batch_size} crops in "
          f"{dt * 1e3:.1f} ms: {rate:.1f} crops/s; "
          f"p50 step time {np.median(times) * 1e3:.3f} ms (10 steps, each "
          f"synchronised); card {card_line()}")

    def three_steps():
        for i in range(3):
            step(state, batches[i % 2])
        torch.cuda.synchronize()

    busy, _ = device_profile(tag, three_steps, f"3 train steps of "
                             f"{TRAIN.batch_size} crops")
    p50 = float(np.median(times)) * 1e3
    idle = 100 * (1 - busy / 3 / p50)
    print(f"[{tag}] device busy {busy / 3:.3f} ms per step against the "
          f"p50 step time {p50:.3f} ms: device idle "
          f"{idle:.1f}% of an unprofiled step")
    return {"rate": rate, "p50": p50, "idle": idle, "busy": busy / 3}


def write_stb_tree(root, rng, frames=None):
    """An STB tree under ``root`` as the loader reads it (no STB file is
    in the repository): the two training and the two evaluation
    sequences of STB_FRAMES 640x480 frames, smooth images (as
    tests/test_native.py makes them: fast to encode and decode), and
    label pickles {"handPara": [3,21,N]} of hands 500-600 mm in front of
    the camera, in mm."""
    from PIL import Image
    frames = frames or STB_FRAMES
    y, x = np.mgrid[0:stb.FRAME_H, 0:stb.FRAME_W]
    os.makedirs(os.path.join(root, "labels"))
    for s, seq in enumerate(STB_TRAIN_SEQS + STB_EVAL_SEQS):
        os.makedirs(os.path.join(root, seq))
        hand = (rng.rand(3, 21, frames) * 100
                + np.array([0.0, 0.0, 500.0])[:, None, None])
        with open(os.path.join(root, "labels", f"{seq}_SK.pkl"), "wb") as f:
            pickle.dump({"handPara": hand}, f)
        for i in range(frames):
            k = s * frames + i
            img = np.stack([(x * 3 + k) % 256, (y * 5 + 7 * k) % 256,
                            (x + y + 3 * k) % 256], -1).astype(np.uint8)
            Image.fromarray(img).save(
                os.path.join(root, seq, f"SK_color_{i}.png"), compress_level=1)


def loader_stages_ms(ds):
    """The loader's cost of one batch of 96, by stage (median of 3): the
    PIL decode and the label math on the host, the upload and the warp on
    the card, and the whole batch as the dataset makes it; the native
    library's batch is one host call."""
    idxs = np.arange(TRAIN_BATCH)
    rows = {}
    for _ in range(3):
        t = [time.perf_counter()]
        if ds.use_native:
            ds._native_batch(idxs, np.random.RandomState(0))
            torch.cuda.synchronize()
            t.append(time.perf_counter())
            rows.setdefault("native batch", []).append(t[1] - t[0])
            continue
        frames = np.stack([ds._load_image(ds.image_paths[i]) for i in idxs])
        t.append(time.perf_counter())
        _, j2d = ds._labels(idxs)
        t.append(time.perf_counter())
        crops, _ = preprocess.fused_crop_pipeline(
            to_device(frames, ds.device), to_device(j2d, ds.device))
        torch.cuda.synchronize()
        t.append(time.perf_counter())
        ds._pil_batch(idxs, np.random.RandomState(0))
        torch.cuda.synchronize()
        t.append(time.perf_counter())
        for name, a, b in (("PIL decode (host)", 0, 1),
                           ("labels (host)", 1, 2),
                           ("upload and warp (card)", 2, 3),
                           ("whole batch", 3, 4)):
            rows.setdefault(name, []).append(t[b] - t[a])
    return {k: 1e3 * float(np.median(v)) for k, v in rows.items()}


def phase_stb(rng, synth):
    """The canonical run on an STB tree (--stage 3 --synthetic_data
    False), the Evaluator on its checkpoint, and serving from frames."""
    card = card_line()
    os.makedirs("build", exist_ok=True)
    with tempfile.TemporaryDirectory(prefix="stb_tree_", dir="build") as root:
        t0 = time.perf_counter()
        write_stb_tree(root, rng)
        print(f"[stb] wrote {4 * STB_FRAMES} 640x480 PNG frames and 4 label "
              f"pickles in {time.perf_counter() - t0:.1f} s")
        opt = dataclasses.replace(STB_TRAIN, data_dir=root)
        decoder = ("native library (native/scat_native.cpp)"
                   if native_loader.available() else "PIL")
        print(f"[stb] decoder serving: {decoder}; card {card}")
        ds = stb.get_loader_STB_eval(opt)
        stages = loader_stages_ms(ds)
        print(f"[stb] loader ms per batch of {TRAIN_BATCH} (median of 3): "
              + ", ".join(f"{k} {v:.3f}" for k, v in stages.items())
              + f"; card {card}")

        # the canonical run on STB: 2 epochs of 2 steps
        t0 = time.perf_counter()
        trainer = Trainer(opt, image_size=IMAGE)
        loader = trainer.train_loader
        assert isinstance(loader, ConcatDataset) and len(loader) == 2, loader
        print(f"[stb] trainer built in {time.perf_counter() - t0:.1f} s "
              f"(--stage 3 --synthetic_data False, {len(loader)} steps an "
              f"epoch)")
        log = os.path.join(opt.checkpoint_folder, "metrics.csv")
        if os.path.exists(log):
            os.remove(log)
        n_steps = opt.epoch * len(loader)
        reset_counts()
        t0 = time.perf_counter()
        trainer.train()
        fwd, bwd = flash_attention.launches, attention_bwd.launches
        print(f"[stb] {opt.epoch} epochs x {len(loader)} steps in "
              f"{time.perf_counter() - t0:.1f} s; attention_fwd launches "
              f"{fwd}, attention_bwd launches {bwd}")
        assert fwd == 3 * n_steps and bwd == 3 * n_steps, (fwd, bwd, n_steps)
        FWD.result["launches"] += fwd
        BWD.result["launches"] += bwd
        with open(log) as f:
            losses = [float(r["loss"]) for r in csv.DictReader(f)]
        assert len(losses) == n_steps and np.isfinite(losses).all(), losses
        path = os.path.join(opt.checkpoint_folder, checkpoint.FINAL_NAME)
        assert os.path.exists(path), path
        print(f"[stb] losses {', '.join(f'{x:.1f}' for x in losses)}; {path}")

        # the rate through the loader, as Trainer.train feeds the step: a
        # window of 3 epochs; then each step synchronised (the time from
        # one step's end to the next one's, the loader's wait included)
        state, step = trainer.state, trainer.train_step

        def epochs(k, sync):
            ends = []
            for _ in range(k):
                for batches in prefetch_to_device(loader, trainer.device):
                    for batch in batches:
                        step(state, batch)
                        if sync:
                            torch.cuda.synchronize()
                            ends.append(time.perf_counter())
            torch.cuda.synchronize()
            return ends

        epochs(1, False)
        t0 = time.perf_counter()
        epochs(3, False)
        dt = time.perf_counter() - t0
        rate = 3 * len(loader) * TRAIN_BATCH / dt
        t0 = time.perf_counter()
        ends = epochs(3, True)
        p50 = 1e3 * float(np.median(np.diff([t0] + ends)))
        _, busy_pct = device_profile(
            "stb", lambda: epochs(1, False),
            f"1 epoch of {len(loader)} steps through the STB loader")
        print(f"[stb] STB training: {rate:.1f} crops/s ({3 * len(loader)} "
              f"steps of {TRAIN_BATCH}), p50 step {p50:.3f} ms, device idle "
              f"{100 - busy_pct:.1f}% of a profiled epoch; the synthetic "
              f"task's {synth['rate']:.1f} crops/s, p50 step "
              f"{synth['p50']:.3f} ms, device idle {synth['idle']:.1f}%; card "
              f"{card}")

        # the Evaluator on the checkpoint, STB_eval at bs 96
        ev_opt = dataclasses.replace(
            opt, checkpoint_path_eval=path, eval_dataset="STB",
            result_dir=os.path.join("build", "chip_smoke_eval"))
        ev = Evaluator(ev_opt, image_size=IMAGE)
        reset_counts()
        t0 = time.perf_counter()
        result = ev.eval()
        dt = time.perf_counter() - t0
        fwd = flash_attention.launches
        n_batches = len(STB_EVAL_SEQS) * STB_FRAMES // TRAIN_BATCH
        print(f"[stb] Evaluator on STB_eval ({n_batches} batches of "
              f"{TRAIN_BATCH}) in {dt * 1e3:.1f} ms: "
              f"{n_batches * TRAIN_BATCH / dt:.1f} crops/s (loader "
              f"included); attention_fwd launches {fwd}; card {card}")
        assert fwd == 3 * n_batches and attention_bwd.launches == 0, fwd
        FWD.result["launches"] += fwd
        assert np.isfinite(result["mpjpe_mm"]) and np.isfinite(result["auc"])
        assert np.isfinite(result["pck"]).all()
        assert ((result["pck"] >= 0) & (result["pck"] <= 100)).all()
        # the same batches through make_eval_step on the plain attention
        # path
        batches = list(make_dataset(ev_opt, IMAGE, training=False))
        before = flash_attention.launches
        plain = Evaluator(dataclasses.replace(
            ev_opt, use_pallas_attention=False, result_dir=os.path.join(
                "build", "chip_smoke_eval_plain")), image_size=IMAGE,
            dataset=batches).eval()
        assert flash_attention.launches == before, "plain path launched"
        d_auc = abs(result["auc"] - plain["auc"]) / 100
        d_mpjpe = abs(result["mpjpe_mm"] - plain["mpjpe_mm"]) / plain[
            "mpjpe_mm"]
        print(f"[stb] kernel vs plain attention path, the same batches: "
              f"MPJPE {result['mpjpe_mm']:.4f} vs {plain['mpjpe_mm']:.4f} mm "
              f"(relative {d_mpjpe:.2e}, bound 1e-2), AUC {result['auc']:.4f} "
              f"vs {plain['auc']:.4f} (percent; difference {d_auc:.2e} of the "
              f"full scale, bound 1e-3), PCK@50 {result['pck'][-1, -1]:.3f}")
        assert d_mpjpe <= 1e-2 and d_auc <= 1e-3, (d_mpjpe, d_auc)

        # serving from whole frames with rough 2D joints
        pred = HandPosePredictor.from_checkpoint(
            dataclasses.replace(opt, checkpoint_path_eval=path),
            image_size=IMAGE)
        idxs = np.arange(7)
        frames = np.stack([ds._load_image(ds.image_paths[i]) for i in idxs])
        hints = np.stack([ds.sample_labels(i)[1] for i in idxs])
        reset_counts()
        got = pred.predict_from_frames(frames, hints)
        fwd = flash_attention.launches
        FWD.result["launches"] += fwd
        assert fwd == 3, fwd
        crops, M = frames_to_crops(frames, hints, IMAGE)
        want = pred.predict(crops)
        for k in want:
            np.testing.assert_array_equal(got[k], want[k], err_msg=k)
        np.testing.assert_array_equal(got["crop_affine"], M)
        check_output(want, 7)
        assert crops.shape == (7, IMAGE, IMAGE, 3) and M.shape == (7, 2, 3)
        print(f"[stb] predict_from_frames on 7 640x480 frames equals "
              f"frames_to_crops then predict; attention_fwd launches {fwd}")


# the datasets phase: trees of DATASET_SAMPLES samples a dataset (two
# batches of 96), the canonical run at --stage 2 for 2 epochs
DATASET_SAMPLES = 192
DATASETS_TRAIN = dataclasses.replace(
    TRAIN, synthetic_data=False, stage=2, epoch=2,
    checkpoint_folder=os.path.join("build", "chip_smoke_datasets"))
STAGE2_WIDTHS = (166, 166, 105, 105, 105)   # FreiHAND, HO-3D, STB, MHP, RHD
HO3D_K = np.array([[614.6, 0.0, 320.0], [0.0, 614.6, 240.0],
                   [0.0, 0.0, 1.0]])


def frame(h, w, k):
    """A smooth frame (fast to encode and decode), shifted by ``k``."""
    y, x = np.mgrid[0:h, 0:w]
    return np.stack([(x * 3 + k) % 256, (y * 5 + 7 * k) % 256,
                     (x + y + 3 * k) % 256], -1).astype(np.uint8)


def write_frei_tree(root, rng, n=DATASET_SAMPLES):
    """FreiHAND beside the STB tree: 224x224 JPEG frames and
    training_{K,xyz,mano}.json, hands 0.5 m from the camera."""
    from PIL import Image
    rgb = os.path.join(root, "FreiHAND", "training", "rgb")
    os.makedirs(rgb)
    labels = {"K": np.tile([[480.0, 0, 112], [0, 480.0, 112], [0, 0, 1]],
                           (n, 1, 1)),
              "xyz": rng.uniform(-0.04, 0.04, (n, 21, 3)) + [0, 0, 0.5],
              "mano": rng.randn(n, 1, 58) * 0.1}
    for name, value in labels.items():
        with open(os.path.join(root, "FreiHAND", f"training_{name}.json"),
                  "w") as f:
            json.dump(value.tolist(), f)
    for i in range(n):
        Image.fromarray(frame(224, 224, i)).save(
            os.path.join(rgb, f"{i:08d}.jpg"))


def write_ho3d_tree(root, rng, n=DATASET_SAMPLES):
    """HO-3D beside the STB tree: train/{seq}/rgb 640x480 PNG frames and
    meta pickles (MANO-order joints in OpenGL camera coordinates, 0.55 m
    away), two sequences."""
    from PIL import Image
    for s, seq in enumerate(("ABF10", "GPMF11")):
        rgb = os.path.join(root, "HO3D", "train", seq, "rgb")
        meta = os.path.join(root, "HO3D", "train", seq, "meta")
        os.makedirs(rgb)
        os.makedirs(meta)
        for i in range(n // 2):
            with open(os.path.join(meta, f"{i:04d}.pkl"), "wb") as f:
                pickle.dump({"handJoints3D": rng.uniform(-0.06, 0.06, (21, 3))
                             + [0, 0, -0.55],
                             "handPose": rng.randn(48) * 0.1,
                             "handBeta": rng.randn(10) * 0.05,
                             "camMat": HO3D_K}, f)
            Image.fromarray(frame(480, 640, 100 * s + i)).save(
                os.path.join(rgb, f"{i:04d}.png"), compress_level=1)


def write_mhp_tree(root, rng, n=DATASET_SAMPLES):
    """MHP beside the STB tree: annotated_frames/data_15 of webcam 1,
    640x480 JPEG frames with world joints (mm) 0.6 m from the camera,
    and its rvec/tvec (the rig's DEFAULT_K)."""
    from PIL import Image
    frames = os.path.join(root, "MHP", "annotated_frames", "data_15")
    calib = os.path.join(root, "MHP", "calibrations", "data_15", "webcam_1")
    os.makedirs(frames)
    os.makedirs(calib)
    for name, value in (("rvec", rng.randn(3) * 0.05),
                        ("tvec", np.array([0.0, 0.0, 50.0]))):
        with open(os.path.join(calib, f"{name}.pkl"), "wb") as f:
            pickle.dump(value.astype(np.float32), f)
    for i in range(n):
        Image.fromarray(frame(480, 640, i)).save(
            os.path.join(frames, f"{i}_webcam_1.jpg"))
        joints = rng.randn(21, 3) * 30.0 + [0, 0, 600.0]
        with open(os.path.join(frames, f"{i}_joints.txt"), "w") as f:
            f.writelines(f"{j} {x} {y} {z}\n"
                         for j, (x, y, z) in enumerate(joints))


def write_rhd_tree(root, rng, n=DATASET_SAMPLES):
    """RHD beside the STB tree: training/color 320x320 PNG frames whose
    two hands are both visible (the left one mirrored by the loader), so
    DATASET_SAMPLES samples, and anno_training.pickle."""
    from PIL import Image
    color = os.path.join(root, "RHD", "training", "color")
    os.makedirs(color)
    anno = {}
    for i in range(n // 2):
        Image.fromarray(frame(320, 320, i)).save(
            os.path.join(color, f"{i:05d}.png"), compress_level=1)
        uv = rng.uniform(80, 240, (42, 2))
        anno[i] = {"xyz": (rng.randn(42, 3) * 0.03 + [0, 0, 0.6]).astype(
                       np.float32),
                   "uv_vis": np.concatenate([uv, np.ones((42, 1))], 1).astype(
                       np.float32),
                   "K": np.eye(3, dtype=np.float32)}
    with open(os.path.join(root, "RHD", "training", "anno_training.pickle"),
              "wb") as f:
        pickle.dump(anno, f)


def median_ms(fn, reps=3):
    """Median wall time of ``fn`` in ms, the card synchronised."""
    times = []
    for _ in range(reps):
        t0 = time.perf_counter()
        fn()
        torch.cuda.synchronize()
        times.append(time.perf_counter() - t0)
    return 1e3 * float(np.median(times))


def dataset_stages_ms(ds):
    """A loader's cost of one batch of 96 by stage (median of 3): PIL's
    decode, the label math and FreiHAND's colour jitter on the host, the
    upload (and the warp) on the card, and the whole batch as the
    dataset makes it."""
    if isinstance(ds, stb.STBDataset):
        return loader_stages_ms(ds)
    idxs = np.arange(TRAIN_BATCH)
    dev = ds.device
    if isinstance(ds, freihand.FreiHANDDataset):
        images = np.stack([ds._load_image(i) for i in idxs]).astype(
            np.float32) / 127.5 - 1.0
        labels = np.stack([ds.sample_labels(i) for i in idxs])
        stages = {
            "PIL decode (host)": lambda: [ds._load_image(i) for i in idxs],
            "labels (host)": lambda: [ds.sample_labels(i) for i in idxs],
            "color jitter (host)": lambda: color_jitter_np(
                np.random.RandomState(0), images),
            "upload (card)": lambda: (to_device(images, dev),
                                      to_device(labels, dev))}
    else:
        if isinstance(ds, ho3d.HO3DDataset):
            paths = [ds.samples[i][0] for i in idxs]

            def sample(i):
                rgb, meta = ds.samples[i]
                return ds._load_image(rgb), ds.sample_labels(meta)[1]
            labels_fn = ("labels (host)",
                         lambda: [ds.sample_labels(ds.samples[i][1])
                                  for i in idxs])
        else:
            if isinstance(ds, mhp.MHPDataset):
                seqs = [(ds.sequences[si], fi)
                        for si, fi in (ds.index[i] for i in idxs)]
                paths = [seq.frames[fi][0] for seq, fi in seqs]

                def sample(i):
                    seq, fi = seqs[i]
                    return seq.get_sample(fi)[:2]
            else:
                paths = [os.path.join(ds.color_dir,
                                      f"{ds.samples[i][0]:05d}.png")
                         for i in idxs]

                def sample(i):
                    return ds.get_sample(i)[:2]
            labels_fn = ("decode and labels (host)",
                         lambda: [sample(i) for i in idxs])
        got = [sample(i) for i in idxs]
        frames = [f for f, _ in got]
        j2d = np.stack([j for _, j in got])
        stages = {
            "PIL decode (host)": lambda: [load_rgb(p) for p in paths],
            labels_fn[0]: labels_fn[1],
            "upload and warp (card)": lambda: preprocess.crop_frames(
                frames, j2d, dev)}
    stages["whole batch"] = lambda: next(iter(ds))
    return {k: median_ms(fn) for k, fn in stages.items()}


def demo_vs_plain(tag, opt, eval_set, card):
    """DemoRunner on ``eval_set``'s sequence: 3 attention_fwd launches a
    frame and no backward, finite MPJPE, ACC and AUC, its frames/s; the
    same sequence on the plain attention path: MPJPE within 1e-2
    relative, AUC within 1e-3 of its full scale, ACC printed.  Returns
    the launches."""
    loader = demo.demo_loader(eval_set, opt)
    runner = demo.DemoRunner(dataclasses.replace(
        opt, result_dir=os.path.join("build", f"chip_smoke_demo_{eval_set}")),
        loader=loader)
    reset_counts()
    t0 = time.perf_counter()
    got = runner.demo()
    dt = time.perf_counter() - t0
    fwd = flash_attention.launches
    print(f"[{tag}] DemoRunner on {eval_set} ({got['frames']} frames) in "
          f"{dt * 1e3:.1f} ms: {got['frames'] / dt:.1f} frames/s (batch 1, "
          f"the sequence's get_sample included); attention_fwd launches "
          f"{fwd}; card {card}")
    assert fwd == 3 * got["frames"] and attention_bwd.launches == 0, fwd
    assert all(np.isfinite(got[k]) for k in ("mpjpe_mm", "acc", "auc")), got
    before = flash_attention.launches
    plain = demo.DemoRunner(dataclasses.replace(
        opt, use_pallas_attention=False, result_dir=os.path.join(
            "build", f"chip_smoke_demo_{eval_set}_plain")),
        loader=demo.demo_loader(eval_set, opt)).demo()
    assert flash_attention.launches == before, "plain path launched"
    d_mpjpe = abs(got["mpjpe_mm"] - plain["mpjpe_mm"]) / plain["mpjpe_mm"]
    d_auc = abs(got["auc"] - plain["auc"]) / 100
    d_acc = abs(got["acc"] - plain["acc"]) / max(abs(plain["acc"]), 1e-30)
    print(f"[{tag}] demo {eval_set}, kernel vs plain attention path: MPJPE "
          f"{got['mpjpe_mm']:.4f} vs {plain['mpjpe_mm']:.4f} mm (relative "
          f"{d_mpjpe:.2e}, bound 1e-2), AUC {got['auc']:.4f} vs "
          f"{plain['auc']:.4f} (difference {d_auc:.2e} of the full scale, "
          f"bound 1e-3), ACC {got['acc']:.4f} vs {plain['acc']:.4f} "
          f"(relative {d_acc:.2e})")
    assert d_mpjpe <= 1e-2 and d_auc <= 1e-3, (d_mpjpe, d_auc)
    return fwd


def evaluator_vs_plain(tag, opt, eval_set, card):
    """The Evaluator on ``eval_set`` at bs 96: 3 launches a batch, none
    backward, finite metrics, crops/s; the same batches on the plain
    attention path within the stb phase's bounds.  Returns the
    launches."""
    ev_opt = dataclasses.replace(
        opt, eval_dataset=eval_set,
        result_dir=os.path.join("build", f"chip_smoke_eval_{eval_set}"))
    ev = Evaluator(ev_opt, image_size=IMAGE)
    reset_counts()
    t0 = time.perf_counter()
    result = ev.eval()
    dt = time.perf_counter() - t0
    fwd = flash_attention.launches
    n_batches = DATASET_SAMPLES // TRAIN_BATCH
    print(f"[{tag}] Evaluator on {eval_set} ({n_batches} batches of "
          f"{TRAIN_BATCH}) in {dt * 1e3:.1f} ms: "
          f"{n_batches * TRAIN_BATCH / dt:.1f} crops/s (loader included); "
          f"attention_fwd launches {fwd}; card {card}")
    assert fwd == 3 * n_batches and attention_bwd.launches == 0, fwd
    assert np.isfinite(result["mpjpe_mm"]) and np.isfinite(result["auc"])
    assert ((result["pck"] >= 0) & (result["pck"] <= 100)).all()
    batches = list(make_dataset(ev_opt, IMAGE, training=False))
    before = flash_attention.launches
    plain = Evaluator(dataclasses.replace(
        ev_opt, use_pallas_attention=False, result_dir=os.path.join(
            "build", f"chip_smoke_eval_{eval_set}_plain")), image_size=IMAGE,
        dataset=batches).eval()
    assert flash_attention.launches == before, "plain path launched"
    d_auc = abs(result["auc"] - plain["auc"]) / 100
    d_mpjpe = abs(result["mpjpe_mm"] - plain["mpjpe_mm"]) / plain["mpjpe_mm"]
    print(f"[{tag}] {eval_set}, kernel vs plain attention path, the same "
          f"batches: MPJPE {result['mpjpe_mm']:.4f} vs "
          f"{plain['mpjpe_mm']:.4f} mm (relative {d_mpjpe:.2e}, bound 1e-2), "
          f"AUC {result['auc']:.4f} vs {plain['auc']:.4f} (difference "
          f"{d_auc:.2e} of the full scale, bound 1e-3)")
    assert d_mpjpe <= 1e-2 and d_auc <= 1e-3, (d_mpjpe, d_auc)
    return fwd


def phase_datasets(rng):
    """The canonical run at --stage 2 --synthetic_data False through the
    FreiHAND, HO-3D, STB, MHP and RHD loaders; the Evaluator on frei and
    ho3d from its checkpoint; the demo on STB and MHP."""
    card = card_line()
    os.makedirs("build", exist_ok=True)
    with tempfile.TemporaryDirectory(prefix="datasets_", dir="build") as root:
        t0 = time.perf_counter()
        write_stb_tree(os.path.join(root, "STB"), rng)
        for writer in (write_frei_tree, write_ho3d_tree, write_mhp_tree,
                       write_rhd_tree):
            writer(root, rng)
        print(f"[datasets] wrote an STB tree ({4 * STB_FRAMES} frames) and "
              f"FreiHAND, HO-3D, MHP and RHD trees of {DATASET_SAMPLES} "
              f"samples beside it in {time.perf_counter() - t0:.1f} s")
        opt = dataclasses.replace(DATASETS_TRAIN,
                                  data_dir=os.path.join(root, "STB"))

        t0 = time.perf_counter()
        trainer = Trainer(opt, image_size=IMAGE)
        loader = trainer.train_loader
        names = [type(d).__name__ for d in loader.datasets]
        assert names == ["FreiHANDDataset", "HO3DDataset", "STBDataset",
                         "MHPDataset", "RHDDataset"], names
        assert len(loader) == DATASET_SAMPLES // TRAIN_BATCH, len(loader)
        print(f"[datasets] trainer built in {time.perf_counter() - t0:.1f} s "
              f"(--stage 2 --synthetic_data False: {', '.join(names)}; "
              f"{len(loader)} tuples an epoch)")
        for ds in loader.datasets:
            stages = dataset_stages_ms(ds)
            print(f"[datasets] {type(ds).__name__} loader ms per batch of "
                  f"{TRAIN_BATCH} (median of 3): " + ", ".join(
                      f"{k} {v:.3f}" for k, v in stages.items())
                  + f"; card {card}")

        # every member step recorded: its label width and its loss
        seen = []
        step = trainer.train_step

        def recording_step(state, batch):
            stats = step(state, batch)
            seen.append((batch["label"].shape[1], stats["loss"]))
            return stats

        trainer.train_step = recording_step
        log = os.path.join(opt.checkpoint_folder, "metrics.csv")
        if os.path.exists(log):
            os.remove(log)
        n_steps = opt.epoch * len(loader) * len(names)
        reset_counts()
        t0 = time.perf_counter()
        trainer.train()
        fwd, bwd = flash_attention.launches, attention_bwd.launches
        trainer.train_step = step
        print(f"[datasets] {opt.epoch} epochs x {len(loader)} tuples of "
              f"{len(names)} member steps in {time.perf_counter() - t0:.1f} "
              f"s; attention_fwd launches {fwd}, attention_bwd launches "
              f"{bwd}")
        assert fwd == 3 * n_steps and bwd == 3 * n_steps, (fwd, bwd, n_steps)
        FWD.result["launches"] += fwd
        BWD.result["launches"] += bwd
        widths = [w for w, _ in seen]
        losses = [float(l) for _, l in seen]
        assert widths == list(STAGE2_WIDTHS) * (n_steps // len(names)), \
            widths
        assert np.isfinite(losses).all(), losses
        with open(log) as f:
            rows = [float(r["loss"]) for r in csv.DictReader(f)]
        assert len(rows) == opt.epoch * len(loader), rows
        np.testing.assert_allclose(
            rows, np.reshape(losses, (len(rows), -1)).mean(1), rtol=1e-4)
        path = os.path.join(opt.checkpoint_folder, checkpoint.FINAL_NAME)
        assert os.path.exists(path), path
        print(f"[datasets] member losses (label width): " + ", ".join(
            f"{l:.1f} ({w})" for w, l in seen) + f"; each metrics.csv row "
            f"the mean of its tuple's {len(names)}; {path}")

        # the rate through the five loaders, as Trainer.train feeds the
        # step: a window of 2 epochs, then 2 epochs each step synchronised
        state = trainer.state

        def epochs(k, sync):
            ends = []
            for _ in range(k):
                for batches in prefetch_to_device(loader, trainer.device):
                    for batch in batches:
                        step(state, batch)
                        if sync:
                            torch.cuda.synchronize()
                            ends.append(time.perf_counter())
            torch.cuda.synchronize()
            return ends

        epochs(1, False)
        t0 = time.perf_counter()
        epochs(2, False)
        dt = time.perf_counter() - t0
        member_steps = 2 * len(loader) * len(names)
        rate = member_steps * TRAIN_BATCH / dt
        t0 = time.perf_counter()
        gaps = np.diff([t0] + epochs(2, True))
        _, busy_pct = device_profile(
            "datasets", lambda: epochs(1, False),
            f"1 epoch of {len(loader)} stage-2 tuples through the loaders")
        print(f"[datasets] stage-2 training: {rate:.1f} crops/s "
              f"({member_steps} member steps of {TRAIN_BATCH}), p50 member "
              f"step {1e3 * np.median(gaps):.3f} ms, mean "
              f"{1e3 * gaps.mean():.3f} ms (the loader's wait included), "
              f"device idle {100 - busy_pct:.1f}% of a profiled epoch; card "
              f"{card}")

        ck = dataclasses.replace(opt, checkpoint_path_eval=path)
        for eval_set in ("frei", "ho3d"):
            FWD.result["launches"] += evaluator_vs_plain(
                "datasets", ck, eval_set, card)
        for eval_set in ("STB", "MHP"):
            FWD.result["launches"] += demo_vs_plain(
                "datasets", ck, eval_set, card)


def phase_group_norm(rng, synth):
    """The flagship with --norm_layer group: serving at buckets 1 and 64
    against the same predictor on the plain attention path and against
    BatchNorm's p50 latencies in this run; 8 synthetic training steps at
    bs 96 (3 + 3 launches a step, a falling loss, one step against the
    plain attention path), its rate beside the train phase's."""
    card = card_line()
    gn = dataclasses.replace(FLAGSHIP, norm_layer="group")
    preds = {"group": HandPosePredictor.from_checkpoint(gn, image_size=IMAGE),
             "batch": HandPosePredictor.from_checkpoint(FLAGSHIP,
                                                        image_size=IMAGE)}
    pred = preds["group"]
    assert sum(isinstance(m, torch.nn.GroupNorm)
               for m in pred.model.modules()) == 53   # resnet50's norms
    for p in preds.values():
        p.warmup()
    crops = {n: rng.randint(0, 256, (n, IMAGE, IMAGE, 3)).astype(np.uint8)
             for n in (1, 64)}
    reset_counts()
    outs = {n: pred.predict(crops[n]) for n in crops}
    fwd = flash_attention.launches
    print(f"[group-norm] requests of 1 and 64 crops: attention_fwd launches "
          f"{fwd}")
    assert fwd == 3 * 2 and attention_bwd.launches == 0, fwd
    FWD.result["launches"] += fwd
    for n, out in outs.items():
        check_output(out, n)
    plain = HandPosePredictor.from_checkpoint(
        dataclasses.replace(gn, use_pallas_attention=False), image_size=IMAGE)
    before = flash_attention.launches
    out_plain = plain.predict(crops[64])
    assert flash_attention.launches == before, "plain path launched"
    del plain
    compare("group-norm", [(f"bf16 kernel vs plain attention, 64 crops, {k}",
                            outs[64][k], out_plain[k], None)
                           for k in out_plain])
    for b in (1, 64):
        x = crops[b]
        row = []
        for name, p in preds.items():
            req_t = []
            for _ in range(20):
                t0 = time.perf_counter()
                p.predict(x)
                req_t.append(time.perf_counter() - t0)
            row.append(f"{name} norm p50 request "
                       f"{np.median(req_t) * 1e3:.3f} ms")
        print(f"[group-norm] bucket {b:2d} (20 requests each): "
              + "; ".join(row) + f"; card {card}")
    del preds, pred

    opt = dataclasses.replace(
        TRAIN, norm_layer="group", epoch=1, steps_per_epoch=8,
        checkpoint_folder=os.path.join("build", "chip_smoke_group_norm"))
    trainer = Trainer(opt, image_size=IMAGE)
    log = os.path.join(opt.checkpoint_folder, "metrics.csv")
    if os.path.exists(log):
        os.remove(log)
    reset_counts()
    trainer.train()
    fwd, bwd = flash_attention.launches, attention_bwd.launches
    print(f"[group-norm] {opt.steps_per_epoch} training steps at bs "
          f"{opt.batch_size}: attention_fwd launches {fwd}, attention_bwd "
          f"launches {bwd}")
    assert fwd == 3 * 8 and bwd == 3 * 8, (fwd, bwd)
    FWD.result["launches"] += fwd
    BWD.result["launches"] += bwd
    with open(log) as f:
        losses = [float(r["loss"]) for r in csv.DictReader(f)]
    assert len(losses) == 8 and np.isfinite(losses).all(), losses
    print(f"[group-norm] losses {', '.join(f'{x:.1f}' for x in losses)}")
    assert np.mean(losses[-2:]) < np.mean(losses[:2]), losses
    batches = list(trainer.train_loader)[:2]
    step_vs_plain("group-norm", trainer.model, batches[0])
    got = train_rate("group-norm", trainer.state, trainer.train_step,
                     batches)
    print(f"[group-norm] training, group vs batch norm in this run: "
          f"{got['rate']:.1f} vs {synth['rate']:.1f} crops/s, p50 step "
          f"{got['p50']:.3f} vs {synth['p50']:.3f} ms, device busy "
          f"{got['busy']:.3f} vs {synth['busy']:.3f} ms a step; card {card}")


# --net reg_transformer_coarse at script/ablation_pose.sh's widths, trained
# through train_coarse's flag line on the synthetic task
COARSE = dataclasses.replace(FLAGSHIP, net="reg_transformer_coarse")
COARSE_ARGV = ("--batch_size 96 --lr 5e-4 --l_weight_3d 100000 --l_weight_2d "
               "10 --vit_heads 8 --vit_depth 3 --mask_rate 0.2 --pos_embed "
               "True --compute_dtype bfloat16 --synthetic_data True --debug "
               "False --epoch 3 --steps_per_epoch 8 --log_every 1 --seed 0 "
               "--checkpoint_folder build/chip_smoke_coarse").split()


def attention_rows(attn):
    """(largest |row sum - 1|, largest such bound) of a softmax matrix: a
    float32 row sums to 1 within 1e-5; a bf16 row within the rounding of
    its entries, sum over i of half a bf16 ulp of p_i (2^(e-8) for p_i in
    [2^e, 2^(e+1))), plus 1e-5."""
    p = attn.float()
    dev = (p.sum(-1) - 1).abs()
    bnd = torch.full_like(dev, 1e-5)
    if attn.dtype == torch.bfloat16:
        half_ulp = torch.exp2(torch.floor(torch.log2(p.clamp(
            min=torch.finfo(torch.float32).tiny))) - 8)
        bnd = bnd + half_ulp.sum(-1)
    assert torch.all(dev <= bnd), (dev.max().item(), bnd.min().item())
    return dev.max().item(), bnd.max().item()


def phase_coarse(rng):
    """The coarse head, --net reg_transformer_coarse (ResNet-50, 21 tokens
    x 784, 8 heads, depth 3, bf16): serving and HTTP, train_coarse's run
    (3 epochs of 8 steps at bs 96, mask_rate 0.2) and its file served, one
    --pl_reg step, the Evaluator with --debug True and its attention dump;
    no attention-kernel launch anywhere (its attention is the plain
    version, which returns P)."""
    card = card_line()
    reset_counts()
    t0 = time.perf_counter()
    pred = HandPosePredictor.from_checkpoint(COARSE, image_size=IMAGE)
    model = pred.model
    assert isinstance(model, EncoderTransformerCoarse)
    assert model.main_encoder.fc1.in_features == 2048      # resnet50
    assert model.transformer.layers[0][1].norm.normalized_shape \
        == ((IMAGE // 8) ** 2,)
    assert model.transformer.layers[0][0].to_qkv.weight.dtype \
        == getattr(torch, COARSE.compute_dtype)
    pred.warmup()
    crops = {n: rng.randint(0, 256, (n, IMAGE, IMAGE, 3)).astype(np.uint8)
             for n in (1, 7, 64)}
    outs = {n: pred.predict(crops[n]) for n in (1, 64)}
    for n, out in outs.items():
        check_output(out, n)
    print(f"[coarse] predictor built and warmed up in "
          f"{time.perf_counter() - t0:.1f} s; requests of 1 and 64 crops: "
          f"finite, root-centred, |joints_3d| max "
          f"{np.abs(outs[64]['joints_3d']).max():.4f}")
    phase_serve(pred, crops, tag="coarse")
    del pred, model

    opt = train_coarse.parse(COARSE_ARGV)
    assert opt.net == "reg_transformer_coarse"
    trainer = Trainer(opt, image_size=IMAGE)
    log = os.path.join(opt.checkpoint_folder, "metrics.csv")
    if os.path.exists(log):
        os.remove(log)
    n_steps = opt.epoch * opt.steps_per_epoch
    t0 = time.perf_counter()
    trainer.train()
    print(f"[coarse] train_coarse: {opt.epoch} epochs x {opt.steps_per_epoch} "
          f"steps at bs {opt.batch_size} in {time.perf_counter() - t0:.1f} s "
          f"(first steps and saves included)")
    with open(log) as f:
        losses = [float(r["loss"]) for r in csv.DictReader(f)]
    assert len(losses) == n_steps and np.isfinite(losses).all(), losses
    quarter = n_steps // 4
    first, last = np.mean(losses[:quarter]), np.mean(losses[-quarter:])
    print(f"[coarse] loss: mean of the first {quarter} steps {first:.1f}, of "
          f"the last {quarter} {last:.1f}")
    assert last < first, (first, last)

    # the final file, served as it is: it equals the trained model cast to
    # the serving dtype
    path = os.path.join(opt.checkpoint_folder, checkpoint.FINAL_NAME)
    served = HandPosePredictor.from_checkpoint(
        dataclasses.replace(COARSE, checkpoint_path_eval=path),
        image_size=IMAGE)
    got = served.predict(crops[7])
    check_output(got, 7)
    mirror = HandPosePredictor(
        model=copy.deepcopy(trainer.model).cast_compute(
            getattr(torch, COARSE.compute_dtype)), image_size=IMAGE)
    for k, v in mirror.predict(crops[7]).items():
        np.testing.assert_array_equal(got[k], v, err_msg=k)
    del served, mirror
    print(f"[coarse] {path} served by HandPosePredictor: equals the trained "
          f"model's {COARSE.compute_dtype} predict")

    batches = list(trainer.train_loader)[:2]
    pl = Trainer(dataclasses.replace(
        opt, pl_reg=True, epoch=1, steps_per_epoch=1,
        checkpoint_folder=os.path.join("build", "chip_smoke_coarse_pl")),
        image_size=IMAGE)
    stats = pl.train_step(pl.state, batches[0])
    loss, loss_pl = stats["loss"].item(), stats["loss_pl"].item()
    print(f"[coarse] one --pl_reg True step: loss {loss:.1f}, path-length "
          f"term {loss_pl:.4g}")
    assert np.isfinite(loss) and np.isfinite(loss_pl) and loss_pl > 0
    del pl

    ev = Evaluator(dataclasses.replace(
        opt, debug=True, checkpoint_path_eval=path, steps_per_epoch=2,
        result_dir=os.path.join("build", "chip_smoke_coarse_eval")),
        image_size=IMAGE)
    assert ev.want_attn
    t0 = time.perf_counter()
    result = ev.eval()
    dt = time.perf_counter() - t0
    print(f"[coarse] Evaluator --debug True, 2 synthetic batches of "
          f"{opt.batch_size} in {dt * 1e3:.1f} ms: MPJPE "
          f"{result['mpjpe_mm']:.3f} mm, AUC {result['auc']:.4f}")
    assert np.isfinite(result["mpjpe_mm"]) and np.isfinite(result["auc"])
    if ev.draw_attn:
        for finger in FINGER_QUERIES:
            for n in (1, 2):
                f = os.path.join(ev.result_dir, "attn", finger,
                                 f"{n:03d}.png")
                assert os.path.getsize(f) > 0, f
        print(f"[coarse] attention dump: attn/{{{','.join(FINGER_QUERIES)}}}"
              f"/001.png and 002.png written")
    else:
        print("[coarse] cv2 unavailable: the dump printed its skip message")
    batch = next(iter(make_dataset(ev.opt, IMAGE, training=False)))
    attn = ev.eval_step(batch)["attn"]
    assert attn.shape == (opt.batch_size, 8, 21, 21), attn.shape
    dev, bnd = attention_rows(attn)
    ev32 = Evaluator(dataclasses.replace(ev.opt, compute_dtype="float32"),
                     image_size=IMAGE)
    dev32, _ = attention_rows(ev32.eval_step(batch)["attn"])
    print(f"[coarse] attn {list(attn.shape)} {str(attn.dtype)[6:]} from the "
          f"eval step's one forward: rows sum to 1 within {dev:.3e} (bound "
          f"{bnd:.3e}: the bf16 rounding of 21 entries); float32 {dev32:.3e} "
          f"(bound 1e-05)")
    del ev, ev32

    train_rate("coarse", trainer.state, trainer.train_step, batches)
    print(f"[coarse] attention_fwd launches {flash_attention.launches}, "
          f"attention_bwd launches {attention_bwd.launches} (plain attention "
          f"on the whole coarse path); card {card}")
    assert flash_attention.launches == 0 and attention_bwd.launches == 0


# the 128-token heads at the JAX package's widths: HRNet-W24 (56x56x128 ->
# 512 channels) and Inception-v3 (768x12x12 -> 192 channels), each to 128
# tokens x 196, 8 heads, dim_head 64, depth 3 (196 -> 98 -> 49 -> 3),
# iteration 3; weights from seed 0
HEAD_NETS = ("backbone_hrnet", "backbone_incepv3")
HEAD_BATCHES = (1, 64, TRAIN_BATCH)


def head_device_ms(tag, fn):
    """Device ms a call of ``fn`` (3 calls profiled, after one)."""
    fn()
    torch.cuda.synchronize()

    def three():
        for _ in range(3):
            fn()
        torch.cuda.synchronize()
    busy, _ = device_profile("token-heads", three, tag)
    return busy / 3


def phase_token_heads(rng):
    """Each 128-token head: eval forwards at bs 1, 64 and 96 on the
    kernel path (3 attention_fwd launches at N = 128 a forward) against
    the plain path on the same weights, bf16 and float32; a train-mode
    forward+backward at bs 96 with 25 of the 128 tokens masked (3 + 3
    launches) against the plain path on the surrogate loss
    pred.float().square().mean(); device ms a forward and a
    forward+backward on each path and the kernels' share of it."""
    card = card_line()
    reset_counts()
    flags = torch.zeros(HEAD_TOKENS, dtype=torch.bool)
    flags[torch.randperm(HEAD_TOKENS, generator=torch.Generator()
                         .manual_seed(0))[:int(0.2 * HEAD_TOKENS)]] = True
    flags = flags.cuda()
    for net in HEAD_NETS:
        t0 = time.perf_counter()
        opt = dataclasses.replace(FLAGSHIP, net=net, mask_rate=0.2)
        model, mean = build_model(opt, IMAGE)
        attns = [m for m in model.modules() if isinstance(m, Attention)]
        assert len(attns) == 3 and all(a.use_kernel for a in attns), \
            "--use_pallas_attention routes the 128-token heads to the kernels"
        assert model.mask_token.shape == (1, 1, 196)
        checkpoint.init_weights(model, seed=0)
        model = model.to("cuda", memory_format=torch.channels_last)
        mean = torch.from_numpy(mean).cuda()
        served = {"bf16": copy.deepcopy(model).cast_compute(
            torch.bfloat16).eval(), "float32": copy.deepcopy(model).eval()}
        print(f"[token-heads] {net}: built in {time.perf_counter() - t0:.1f} "
              f"s; {sum(p.numel() for p in model.parameters())} parameters")
        pairs = []
        for b in HEAD_BATCHES:
            x = torch.from_numpy(rng.uniform(
                -1, 1, (b, IMAGE, IMAGE, 3)).astype(np.float32)).cuda()
            x = x.permute(0, 3, 1, 2)   # NHWC crops as the predictor's view
            for dt, m in served.items():
                out = {}
                for on in (True, False):
                    set_kernel(m, on)
                    before = flash_attention.launches
                    with torch.no_grad():
                        pred = m(x)
                    assert flash_attention.launches - before == \
                        (3 if on else 0), (net, dt, on)
                    assert pred.shape == (b, 61) and \
                        torch.isfinite(pred).all()
                    # the regressed part: the prediction less its mean
                    out[on] = (pred - mean).cpu().numpy()
                pairs.append((f"{net} {dt} kernel vs plain attention, bs "
                              f"{b}, pred - mean", out[True], out[False],
                              None if dt == "bf16" else F32_ATOL))
        compare("token-heads", pairs)

        model.train().set_compute_dtype(torch.bfloat16)
        x = torch.from_numpy(rng.uniform(-1, 1, (
            TRAIN_BATCH, IMAGE, IMAGE, 3)).astype(np.float32)).cuda()
        x = x.permute(0, 3, 1, 2)

        def fwd_bwd():
            model.zero_grad(set_to_none=True)
            pred = model(x, token_mask=flags)
            loss = pred.float().square().mean()
            loss.backward()
            return loss

        got = {}
        for on in (True, False):
            set_kernel(model, on)
            before = flash_attention.launches, attention_bwd.launches
            loss = fwd_bwd()
            norm = torch.sqrt(sum((p.grad.float() ** 2).sum()
                                  for p in model.parameters()
                                  if p.grad is not None))
            assert (flash_attention.launches - before[0],
                    attention_bwd.launches - before[1]) == \
                ((3, 3) if on else (0, 0)), (net, on)
            got[on] = (loss.item(), norm.item())
        failed = []
        for i, what in enumerate(("loss", "global gradient norm")):
            k, p = got[True][i], got[False][i]
            diff, bnd = abs(k - p), BF16_REL * abs(p)
            print(f"[token-heads] {net} train mode, bs {TRAIN_BATCH}, 25 of "
                  f"128 tokens masked, bf16: kernel vs plain attention, "
                  f"{what}: {k:.6g} vs {p:.6g}, diff {diff:.4e} (bound "
                  f"{bnd:.4e})")
            if not diff <= bnd:
                failed.append(what)
        assert not failed, failed

        times = {}
        ev = served["bf16"]
        xe = x.detach()
        for on in (True, False):
            path = "kernel" if on else "plain"
            set_kernel(ev, on)
            set_kernel(model, on)
            with torch.no_grad():
                times[f"forward {path}"] = head_device_ms(
                    f"{net} eval forward bs {TRAIN_BATCH} bf16, {path} "
                    f"attention", lambda: ev(xe))
            times[f"forward+backward {path}"] = head_device_ms(
                f"{net} train forward+backward bs {TRAIN_BATCH} bf16, "
                f"{path} attention", fwd_bwd)
        print(f"[token-heads] {net} device ms (bs {TRAIN_BATCH}, bf16): "
              + ", ".join(f"{k} {v:.3f}" for k, v in times.items())
              + f"; card {card}")
        del model, served, ev
    fwd, bwd = flash_attention.launches, attention_bwd.launches
    print(f"[token-heads] attention_fwd launches {fwd}, attention_bwd "
          f"launches {bwd} at [B,8,128,64]")
    FWD.result["launches"] += fwd
    BWD.result["launches"] += bwd


# --net ViT at the JAX package's defaults (scat_tpu/config.py:57-62): 224
# px in 16x16 patches, 196 tokens + cls x 256, depth 3 (256 -> 128 -> 64
# -> 3), 8 heads x 64, iteration 1, bf16, weights from seed 0; the plain
# attention path, as the JAX package builds it
VIT = Options(net="ViT", compute_dtype="bfloat16", checkpoint_path_eval="",
              seed=0)
VIT_TRAIN = dataclasses.replace(
    VIT, batch_size=TRAIN_BATCH, lr=5e-4, l_weight_3d=1e5, l_weight_2d=10.0,
    synthetic_data=True, debug=False, epoch=3, steps_per_epoch=8,
    log_every=1, checkpoint_folder=os.path.join("build", "chip_smoke_vit"))
# --net frankmocap: H3DW on resnet50 at 224 px, bf16; the synthetic MANO
# of extra_data/hand.obj (MANO_RIGHT.pkl is not in the repository)
FRANKMOCAP = Options(net="frankmocap", compute_dtype="bfloat16",
                     checkpoint_path_eval="", seed=0,
                     batch_size=TRAIN_BATCH, synthetic_data=True,
                     steps_per_epoch=2)
# the temporal stage at the JAX package's defaults: 16-frame windows at
# stride 8, 2 windows a step, GRU 1024 x 2 with attention pooling,
# VIBELossConfig(), bf16 encoder; 4 videos of 48 frames from seed 0
VIDEO = Options(net="frankmocap", compute_dtype="bfloat16", seed=0,
                epoch=2)
VIDEO_SEQLEN, VIDEO_STRIDE, VIDEO_WINDOWS = 16, 8, 2
VIDEO_COUNT, VIDEO_FRAMES = 4, 48


def no_kernel_launch(tag):
    """The phase's path launched none of the kernels (the JAX package's
    ViT, MANO and temporal stage reach no Pallas kernel)."""
    counts = {k.name: k.wrapper.launches for k in KERNELS}
    assert not any(counts.values()), (tag, counts)


def serving_rate(tag, pred, rng, requests=WINDOW_REQUESTS,
                 crops=WINDOW_CROPS):
    """The end-to-end rate over a window of back-to-back requests of
    ``crops`` crops, the p50 request latency at buckets 1 and 64, and a
    profile of one 256-crop request."""
    big = pred._buckets[-1]
    window = [rng.randint(0, 256, (crops, IMAGE, IMAGE, 3), dtype=np.uint8)
              for _ in range(requests)]
    pred.predict(window[0])
    t0 = time.perf_counter()
    for x in window:
        pred.predict(x)
    dt = time.perf_counter() - t0
    n = requests * crops
    print(f"[{tag}] end to end: {requests} back-to-back requests of "
          f"{crops} uint8 crops (chunks of {big}), {n} crops in "
          f"{dt * 1e3:.1f} ms: {n / dt:.1f} crops/s")
    for b in (1, big):
        x = rng.randint(0, 256, (b, IMAGE, IMAGE, 3), dtype=np.uint8)
        req_t = []
        for _ in range(20):
            t0 = time.perf_counter()
            pred.predict(x)
            req_t.append(time.perf_counter() - t0)
        print(f"[{tag}] bucket {b:2d}: p50 request latency "
              f"{np.median(req_t) * 1e3:.3f} ms (20 requests)")
    x = window[1][:256]
    device_profile(tag, lambda: pred.predict(x), f"256 crops in chunks of "
                   f"{big}")


def phase_vit(rng):
    """--net ViT: served (requests of 1, 7, 64, 150 crops, HTTP), the
    float32 forward on the card against the CPU, trained (3 epochs of 8
    steps at bs 96, the file served as it is), evaluated; rates and
    profiles; no attention-kernel launch."""
    card = card_line()
    reset_counts()
    t0 = time.perf_counter()
    pred = HandPosePredictor.from_checkpoint(VIT, image_size=IMAGE)
    model = pred.model
    assert isinstance(model, ViT) and model.tokens == 197
    assert model.transformer.dims == [256, 128, 64]
    assert model.patch_to_embedding.weight.dtype == torch.bfloat16
    assert model.head[0].weight.dtype == torch.float32
    assert not any(m.use_kernel for m in model.modules()
                   if isinstance(m, Attention))
    pred.warmup()
    print(f"[vit] predictor built and warmed up in "
          f"{time.perf_counter() - t0:.1f} s (224 px, 197 tokens x 256, "
          f"depth 3, 8 heads x 64, iteration 1, bf16)")
    crops = {n: rng.randint(0, 256, (n, IMAGE, IMAGE, 3)).astype(np.uint8)
             for n in REQUESTS}
    outs = {n: pred.predict(crops[n]) for n in REQUESTS}
    for n, out in outs.items():
        check_output(out, n, root_centred=False)
    f32 = dataclasses.replace(VIT, compute_dtype="float32")
    o32 = HandPosePredictor.from_checkpoint(f32, image_size=IMAGE).predict(
        crops[7])
    cpu = HandPosePredictor.from_checkpoint(
        f32, image_size=IMAGE, device="cpu").predict(crops[7])
    compare("vit", [("float32 on the card (TF32 off) vs the CPU, 7 crops, "
                     "joints_3d", o32["joints_3d"], cpu["joints_3d"], 1e-4)])
    diff = float(np.abs(outs[7]["joints_3d"] - o32["joints_3d"]).max())
    print(f"[vit] bf16 vs float32 on the card, 7 crops, joints_3d: max abs "
          f"diff {diff:.4e} (|joints_3d| max "
          f"{np.abs(o32['joints_3d']).max():.4f})")
    phase_serve(pred, crops, tag="vit")
    serving_rate("vit", pred, rng)
    del pred, model

    trainer = Trainer(VIT_TRAIN, image_size=IMAGE)
    log = os.path.join(VIT_TRAIN.checkpoint_folder, "metrics.csv")
    if os.path.exists(log):
        os.remove(log)
    n_steps = VIT_TRAIN.epoch * VIT_TRAIN.steps_per_epoch
    t0 = time.perf_counter()
    trainer.train()
    print(f"[vit] {VIT_TRAIN.epoch} epochs x {VIT_TRAIN.steps_per_epoch} "
          f"steps at bs {VIT_TRAIN.batch_size} in "
          f"{time.perf_counter() - t0:.1f} s (first steps and saves "
          f"included)")
    with open(log) as f:
        losses = [float(r["loss"]) for r in csv.DictReader(f)]
    assert len(losses) == n_steps and np.isfinite(losses).all(), losses
    quarter = n_steps // 4
    first, last = np.mean(losses[:quarter]), np.mean(losses[-quarter:])
    print(f"[vit] loss: mean of the first {quarter} steps {first:.1f}, of "
          f"the last {quarter} {last:.1f}")
    assert last < first, (first, last)
    path = os.path.join(VIT_TRAIN.checkpoint_folder, checkpoint.FINAL_NAME)
    served = HandPosePredictor.from_checkpoint(
        dataclasses.replace(VIT, checkpoint_path_eval=path),
        image_size=IMAGE)
    got = served.predict(crops[7])
    check_output(got, 7, root_centred=False)
    mirror = HandPosePredictor(
        model=copy.deepcopy(trainer.model).cast_compute(torch.bfloat16),
        image_size=IMAGE)
    for k, v in mirror.predict(crops[7]).items():
        np.testing.assert_array_equal(got[k], v, err_msg=k)
    del served, mirror
    print(f"[vit] {path} served by HandPosePredictor: equals the trained "
          f"model's bf16 predict")

    ev = Evaluator(dataclasses.replace(
        VIT_TRAIN, checkpoint_path_eval=path, steps_per_epoch=2,
        result_dir=os.path.join("build", "chip_smoke_vit_eval")),
        image_size=IMAGE)
    t0 = time.perf_counter()
    result = ev.eval()
    dt = time.perf_counter() - t0
    pck = result["pck"]
    print(f"[vit] Evaluator, 2 synthetic batches of {TRAIN_BATCH} in "
          f"{dt * 1e3:.1f} ms: MPJPE {result['mpjpe_mm']:.3f} mm, AUC "
          f"{result['auc']:.4f}, PCK@50 {pck[-1, -1]:.2f} %")
    assert np.isfinite(result["mpjpe_mm"]) and np.isfinite(result["auc"])
    assert np.isfinite(pck).all() and ((pck >= 0) & (pck <= 100)).all()
    del ev
    batches = list(trainer.train_loader)[:2]
    train_rate("vit", trainer.state, trainer.train_step, batches)
    no_kernel_launch("vit")
    print(f"[vit] no kernel launch (the plain attention, as in the JAX "
          f"package); card {card}")


def decode_profile(tag, fn, calls=10):
    """Device time and kernel launches of one call of ``fn`` (``calls``
    profiled, after one), and its top device operations."""
    fn()
    torch.cuda.synchronize()
    acts = [torch.profiler.ProfilerActivity.CPU,
            torch.profiler.ProfilerActivity.CUDA]
    with torch.profiler.profile(activities=acts) as prof:
        for _ in range(calls):
            fn()
        torch.cuda.synchronize()
    events = [e for e in prof.key_averages()
              if e.device_type == torch.autograd.DeviceType.CUDA
              and e.self_device_time_total > 0
              and not getattr(e, "is_user_annotation", False)]
    busy = sum(e.self_device_time_total for e in events) / calls / 1e3
    launches = sum(e.count for e in events) / calls
    print(f"[{tag}] device {busy:.4f} ms and {launches:.0f} kernel launches "
          f"a call ({calls} calls profiled)")
    for e in sorted(events, key=lambda e: -e.self_device_time_total)[:8]:
        print(f"[{tag}]   {e.self_device_time_total / calls / 1e3:9.4f} ms "
              f"x{e.count / calls:<5.0f} {e.key[:110]}")
    return busy, launches


def write_crops(folder, rng, n=16):
    """``n`` PNG crops of assorted sizes for the Tester."""
    from PIL import Image
    os.makedirs(folder, exist_ok=True)
    for f in os.listdir(folder):
        os.remove(os.path.join(folder, f))
    for i in range(n):
        h, w = rng.randint(96, 400, 2)
        Image.fromarray(rng.randint(0, 256, (h, w, 3)).astype(
            np.uint8)).save(os.path.join(folder, f"crop_{i:02d}.png"))


def phase_mano(rng):
    """--net frankmocap: the MANO decode on the card in float32 against
    the CPU at bs 96, its device time and launches; the Tester on 16
    written crops; the Evaluator through H3DWJointsEncoder."""
    card = card_line()
    reset_counts()
    cpu = mano.ManoModel.from_data()
    dev = cpu.to("cuda")
    b = TRAIN_BATCH
    rots = rng.randn(b, 3).astype(np.float32) * 0.5
    poses = rng.randn(b, 45).astype(np.float32) * 0.3
    betas = rng.randn(b, 10).astype(np.float32)
    rots[0] = 0.0   # the guarded Rodrigues' Taylor branch
    args = [torch.from_numpy(a) for a in (rots, poses, betas)]
    want = mano.rot_pose_beta_to_mesh(cpu, *args).numpy()
    cargs = [a.cuda() for a in args]
    got = mano.rot_pose_beta_to_mesh(dev, *cargs)
    got16 = mano.rot_pose_beta_to_mesh(dev, *(a.bfloat16() for a in cargs))
    assert got.dtype == torch.float32 and got16.dtype == torch.float32
    compare("mano", [(f"float32 decode on the card vs the CPU, bs {b}, 21 "
                      f"joints + 778 vertices", got.cpu().numpy(), want,
                      1e-5)])
    busy, launches = decode_profile(
        "mano", lambda: mano.rot_pose_beta_to_mesh(dev, *cargs))
    print(f"[mano] rot_pose_beta_to_mesh at bs {b}: {busy:.4f} ms device, "
          f"{launches:.0f} launches (the 16-joint chain composes 15 4x4 "
          f"matmuls one joint at a time); card {card}")

    folder = os.path.join("build", "chip_smoke_mano", "rgb")
    write_crops(folder, rng)
    opt = dataclasses.replace(
        FRANKMOCAP, result_dir=os.path.join("build", "chip_smoke_mano",
                                            "out"))
    t0 = time.perf_counter()
    tester = Tester(opt, image_size=IMAGE)
    assert tester.model.main_encoder.fc1.in_features == 2048   # resnet50
    print(f"[mano] Tester built in {time.perf_counter() - t0:.1f} s")
    tester.test(folder)   # warm-up: convolution algorithms, decode
    t0 = time.perf_counter()
    results = tester.test(folder)
    dt = time.perf_counter() - t0
    assert len(results) == 16
    for r in results:
        assert r["pred_params"].shape == (61,)
        assert r["joints_3d"].shape == (21, 3)
        assert r["verts"].shape == (778, 3)
        assert r["joints_2d"].shape == (21, 2)
        for k in ("pred_params", "joints_3d", "verts", "joints_2d"):
            assert np.isfinite(r[k]).all(), (r["name"], k)
        stem = os.path.splitext(r["name"])[0]
        assert os.path.getsize(os.path.join(opt.result_dir,
                                            f"{stem}_params.txt")) > 0
    overlays = importlib.util.find_spec("matplotlib") is not None
    if overlays:
        assert os.path.getsize(os.path.join(
            opt.result_dir, "crop_00_overlay.png")) > 0
    print(f"[mano] Tester on 16 crops: {16 / dt:.1f} images/s ({dt * 1e3:.1f}"
          f" ms, one image at a time, PNG decode included); params, joints, "
          f"vertices and 2D joints finite; {{stem}}_params.txt written; "
          + ("overlays written" if overlays else
             "no matplotlib: the overlays' skip message printed"))
    del tester

    ev = Evaluator(dataclasses.replace(
        FRANKMOCAP, result_dir=os.path.join("build", "chip_smoke_mano_eval")),
        image_size=IMAGE)
    assert isinstance(ev.model, H3DWJointsEncoder)
    t0 = time.perf_counter()
    result = ev.eval()
    dt = time.perf_counter() - t0
    print(f"[mano] Evaluator through H3DWJointsEncoder, 2 synthetic batches "
          f"of {TRAIN_BATCH} in {dt * 1e3:.1f} ms: MPJPE "
          f"{result['mpjpe_mm']:.3f} mm, AUC {result['auc']:.4f}")
    assert np.isfinite(result["mpjpe_mm"]) and np.isfinite(result["auc"])
    assert np.isfinite(result["pck"]).all()
    no_kernel_launch("mano")


def video_data(rng):
    """4 videos x 48 frames at 224 px: smooth noise frames in [-1, 1] and
    166-float labels (pose 3:51, 3D joints 61:124, 2D joints 124:166)."""
    n = VIDEO_COUNT * VIDEO_FRAMES
    base = rng.uniform(-1, 1, (VIDEO_COUNT, 1, IMAGE, IMAGE, 3))
    drift = rng.uniform(-0.02, 0.02, (VIDEO_COUNT, VIDEO_FRAMES, 1, 1, 3))
    images = np.clip(base + np.cumsum(drift, axis=1), -1, 1).astype(
        np.float32).reshape(n, IMAGE, IMAGE, 3)
    labels = np.concatenate([
        rng.randn(n, 61) * 0.1, rng.randn(n, 63) * 0.03,
        rng.rand(n, 42) * IMAGE], 1).astype(np.float32)
    vids = np.repeat([f"video_{i}" for i in range(VIDEO_COUNT)],
                     VIDEO_FRAMES)
    return images, labels, vids


def event_ms(fn, reps=10):
    """ms a call of ``fn`` over ``reps`` back-to-back calls, CUDA events
    (the host's launch gaps included), after two warm-up calls."""
    for _ in range(2):
        fn()
    start = torch.cuda.Event(enable_timing=True)
    end = torch.cuda.Event(enable_timing=True)
    torch.cuda.synchronize()
    start.record()
    for _ in range(reps):
        fn()
    end.record()
    end.synchronize()
    return start.elapsed_time(end) / reps


def phase_video(rng):
    """The temporal stage: VideoTrainer for 2 epochs (finite losses,
    d_real and d_fake), one step against the same step with the encoder
    in float32, the discriminator untouched by the generator's update;
    sequences/s, p50 step, a profile and the step split into encoder,
    MANO decode, GRU and losses."""
    card = card_line()
    reset_counts()
    images, labels, vids = video_data(rng)
    ds = VideoChunkDataset(images, labels, vids, seqlen=VIDEO_SEQLEN,
                           stride=VIDEO_STRIDE, batch_size=VIDEO_WINDOWS)
    per_video = (VIDEO_FRAMES - VIDEO_SEQLEN) // VIDEO_STRIDE + 1
    assert len(ds.windows) == VIDEO_COUNT * per_video
    assert len(ds) == len(ds.windows) // VIDEO_WINDOWS
    trainer = VideoTrainer(VIDEO, image_size=IMAGE)
    disc = trainer.discriminator
    assert disc.gru.hidden_size == 1024 and disc.gru.num_layers == 2
    assert disc.feature_pool == "attention"
    t0 = time.perf_counter()
    state = trainer.train(ds)
    print(f"[video] VideoTrainer: {VIDEO.epoch} epochs of {len(ds)} steps "
          f"({VIDEO_WINDOWS} windows of {VIDEO_SEQLEN} frames, resnet50 "
          f"H3DW at 224 px bf16, GRU 1024 x 2, attention pooling) in "
          f"{time.perf_counter() - t0:.1f} s (first steps included)")
    assert state.step == VIDEO.epoch * len(ds)
    batches = list(ds)[:2]
    step = make_adversarial_train_step(trainer.mano, grad_norms=True)
    stats = {k: v.item() for k, v in step(state, batches[0]).items()}
    for k, v in stats.items():
        assert np.isfinite(v), (k, v)
    print(f"[video] one more step: gen {stats['gen_loss']:.4f}, disc "
          f"{stats['disc_loss']:.4f} (d_real {stats['d_real']:.4f}, d_fake "
          f"{stats['d_fake']:.4f}), gradient norms {stats['gen_grad_norm']:.4g}"
          f" / {stats['disc_grad_norm']:.4g}")

    # the generator's update leaves the discriminator as it is: its
    # parameters, and no gradient written into it
    state.discriminator.zero_grad(set_to_none=True)
    before = [p.detach().clone() for p in state.discriminator.parameters()]
    enc_before = state.encoder.regressor[0].weight.detach().clone()
    fake, _ = adversarial.generator_step(state, batches[1], trainer.mano)
    for p, b in zip(state.discriminator.parameters(), before):
        assert torch.equal(p, b) and p.grad is None
    assert not torch.equal(state.encoder.regressor[0].weight, enc_before)
    adversarial.discriminator_step(state, fake, batches[1]["real_theta"])
    print("[video] generator_step: the discriminator's parameters equal "
          "their values before it and hold no gradient; the encoder moved")

    # one step from the same weights and batch, bf16 against float32
    got = {}
    for dtype in (torch.bfloat16, torch.float32):
        disc_twin = copy.deepcopy(state.discriminator)
        disc_twin.gru.flatten_parameters()   # a copy's weights are apart
        twin = adversarial.AdversarialTrainState.create(
            copy.deepcopy(state.encoder).set_compute_dtype(dtype), disc_twin,
            VIDEO.lr, VIDEO.lr * 0.1)
        s = step(twin, batches[0])
        got[dtype] = (s["gen_loss"].item(), s["disc_loss"].item())
        del twin
    failed = []
    for i, what in enumerate(("generator loss", "discriminator loss")):
        a, b = got[torch.bfloat16][i], got[torch.float32][i]
        diff, bnd = abs(a - b), BF16_REL * abs(b)
        print(f"[video] one step, bf16 vs float32 encoder, {what}: {a:.6g} "
              f"vs {b:.6g}, diff {diff:.4e} (bound {bnd:.4e})")
        if not diff <= bnd:
            failed.append(what)
    assert not failed, failed

    # rates: a window of 10 steps, and the p50 of 10 synchronised steps,
    # of the step VideoTrainer runs (no gradient norms)
    step = make_adversarial_train_step(trainer.mano)
    for i in range(3):
        step(state, batches[i % 2])
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    for i in range(10):
        step(state, batches[i % 2])
    torch.cuda.synchronize()
    dt = time.perf_counter() - t0
    times = []
    for i in range(10):
        t1 = time.perf_counter()
        step(state, batches[i % 2])
        torch.cuda.synchronize()
        times.append(time.perf_counter() - t1)
    p50 = float(np.median(times)) * 1e3
    print(f"[video] rate: 10 steps of {VIDEO_WINDOWS} windows x "
          f"{VIDEO_SEQLEN} frames in {dt * 1e3:.1f} ms: "
          f"{10 * VIDEO_WINDOWS / dt:.2f} sequences/s "
          f"({10 * VIDEO_WINDOWS * VIDEO_SEQLEN / dt:.1f} frames/s); p50 "
          f"step {p50:.3f} ms; card {card}")

    # does the step wait for the card anywhere? Under the sync debug
    # mode each synchronising call it detects warns ("called a
    # synchronizing CUDA operation"; the mode's own notice is not one)
    with warnings.catch_warnings(record=True) as caught:
        warnings.simplefilter("always")
        torch.cuda.set_sync_debug_mode("warn")
        try:
            step(state, batches[0])
        finally:
            torch.cuda.set_sync_debug_mode("default")
    syncs = [str(w.message) for w in caught
             if "called a synchronizing" in str(w.message)]
    print(f"[video] one step under the sync debug mode: {len(syncs)} "
          f"synchronising call(s)" + (f", the first: {syncs[0][:160]}"
                                      if syncs else ""))

    def three_steps():
        for i in range(3):
            step(state, batches[i % 2])
        torch.cuda.synchronize()
    busy, _ = device_profile("video", three_steps,
                             f"3 adversarial steps of {VIDEO_WINDOWS} x "
                             f"{VIDEO_SEQLEN} frames")
    print(f"[video] device busy {busy / 3:.3f} ms a step against the p50 "
          f"step {p50:.3f} ms: idle {100 * (1 - busy / 3 / p50):.1f}% of an "
          f"unprofiled step")

    # the step's parts, each timed alone at the step's shapes (forward
    # and backward): the encoder over 32 frames, the MANO decode, the GRU
    # discriminator's three passes, the losses
    enc, disc = state.encoder, state.discriminator
    x = batches[0]["image"].reshape(-1, IMAGE, IMAGE, 3).permute(0, 3, 1, 2)
    B, T = VIDEO_WINDOWS, VIDEO_SEQLEN
    with torch.no_grad():
        thetas = enc(x)[1].float()
    lab = batches[0]["label"]

    def encoder_part():
        enc(x)[1].float().sum().backward()

    def decode_part():
        th = thetas.clone().requires_grad_()
        j, j2 = adversarial.decode_thetas(trainer.mano, th)
        (j.sum() + j2.sum()).backward()

    def gru_part():
        th = thetas.reshape(B, T, 61).clone().requires_grad_()
        disc(th[:, :, 3:51]).sum().backward()
        (disc(th.detach()[:, :, 3:51]).sum()
         + disc(batches[0]["real_theta"][:, :, 3:51]).sum()).backward()

    joints, j2d = adversarial.decode_thetas(trainer.mano, thetas)
    fake_val = disc(thetas.reshape(B, T, 61)[:, :, 3:51]).detach()

    def loss_part():
        th = thetas.reshape(B, T, 61).clone().requires_grad_()
        gt = torch.cat([torch.zeros_like(lab[..., :3]), lab[..., 3:51],
                        torch.zeros_like(lab[..., :10])], -1)
        fv = fake_val.clone().requires_grad_()
        total, _ = vibe_loss.vibe_generator_loss(
            vibe_loss.VIBELossConfig(), th, j2d.reshape(B, T, 21, 2),
            joints.reshape(B, T, 21, 3), lab[..., 124:].reshape(B, T, 21, 2),
            lab[..., 61:124].reshape(B, T, 21, 3), gt, disc_fake_value=fv)
        d = vibe_loss.vibe_discriminator_loss(
            vibe_loss.VIBELossConfig(), fv, fv)[2]
        (total + d).backward()

    parts = {f"encoder ({B * T} frames)": event_ms(encoder_part),
             "MANO decode": event_ms(decode_part),
             "GRU discriminator (3 passes)": event_ms(gru_part),
             "losses": event_ms(loss_part)}
    enc.zero_grad(set_to_none=True)
    disc.zero_grad(set_to_none=True)
    print("[video] the step's parts alone, forward + backward, CUDA events "
          "over 10 calls: " + ", ".join(
              f"{k} {v:.3f} ms ({100 * v / p50:.1f}% of the p50 step)"
              for k, v in parts.items()))
    no_kernel_launch("video")


def favor_operands(b, h, t, e, m, dtype, seed):
    """k, q, v as the Performer block passes them (strided [B,H,T,e]
    views of one [B,T,H,3e] kqv output, k and q scaled by 0.5 as ViP's
    are about) and w N(0,1) [m, e] float32."""
    g = torch.Generator().manual_seed(seed)
    kqv = torch.randn(b, t, h, 3 * e, generator=g)
    kqv[..., :2 * e] *= 0.5
    k, q, v = kqv.to("cuda", dtype).permute(0, 2, 1, 3).split(e, dim=-1)
    return q, k, v, torch.randn(m, e, generator=g).cuda()


def outside(got, want):
    """How many elements of ``got`` lie outside FAVOR_RTOL / FAVOR_ATOL
    of ``want``."""
    tol = FAVOR_ATOL + FAVOR_RTOL * want.abs()
    return int(((got - want).abs() > tol).sum().item())


# bf16x3 products of each bf16 kernel's design, per 2 m e flops of its
# float32 formula (a row's features and its second product): the stats
# kernel splits w (3 products) and phi (3); the apply kernel splits w (3)
# and keeps six of the nine products of phi's and kptv's parts
TC_PRODUCTS = {"favor_stats": 3 + 3, "favor_apply": 3 + 6}


def favor_work(b, h, t, e, m, in_bytes):
    """{kernel: (bytes, flops)} of one stats and one apply launch: each
    input read once and each output written once (y in float32); the
    flops of the two dot products a row (4 m e) and of |x|^2, exp, the
    scale, ksum, D and the division."""
    bh, rows = b * h, b * h * t
    stats_out = bh * (m + m * e) * 4
    return {
        "favor_stats": (2 * rows * e * in_bytes + m * e * 4 + stats_out,
                        rows * (4 * m * e + 2 * e + 3 * m)),
        "favor_apply": (rows * e * in_bytes + m * e * 4 + stats_out
                        + rows * e * 4,
                        rows * (4 * m * e + 3 * e + 4 * m))}


def phase_favor_kernels():
    for i, shape in enumerate(FAVOR_SHAPES):
        for dtype in (torch.float32, torch.bfloat16):
            q, k, v, w = favor_operands(*shape, dtype, seed=200 + i)
            ksum, kptv = favor_stats(k, v, w)
            y = favor_apply(q, ksum, kptv, w)
            torch.cuda.synchronize()
            # the plain versions on the operands' values: the stats in
            # float32, and the apply alone (on the kernel's stats) and the
            # chain (plain stats, then plain apply) at the precision the
            # kernel is held to.  float32 operands share the float32 plain
            # versions' arithmetic and are held against them; the bf16
            # kernels' bf16x3 split products are closer to float64 than
            # the float32 plain versions are, whose own error reaches half
            # the tolerance, so the bf16 apply and chain are held against
            # the plain versions run in float64
            wks, wkv = favor_stats_reference(k.float(), v.float(), w)
            wide = torch.float32 if dtype == torch.float32 else torch.float64
            qw, ww = q.to(wide), w.to(wide)
            wy = favor_apply_reference(qw, ksum.to(wide), kptv.to(wide),
                                       ww).float()
            chain = favor_apply_reference(
                qw, *favor_stats_reference(k.to(wide), v.to(wide), ww),
                ww).float()
            del qw
            scale = wkv.abs().max().item()
            s_err = max((ksum - wks).abs().max().item(),
                        (kptv - wkv).abs().max().item())
            y_err = (y - wy).abs().max().item()
            c_err = (y - chain).abs().max().item()
            for got, want in ((ksum, wks), (kptv, wkv)):
                torch.testing.assert_close(
                    got, want, rtol=FAVOR_RTOL,
                    atol=FAVOR_ATOL * want.abs().max().item())
            for want in (wy, chain):
                torch.testing.assert_close(y, want, rtol=FAVOR_RTOL,
                                           atol=FAVOR_ATOL)
            assert torch.equal(favor_stats(k, v, w)[1], kptv), \
                "favor_stats is not deterministic"
            assert torch.equal(favor_apply(q, ksum, kptv, w), y), \
                "favor_apply is not deterministic"
            f32 = ""
            if dtype == torch.bfloat16:
                # beside it, the float32 plain apply on the same stats:
                # its distance to the kernel and to float64
                y32 = favor_apply_reference(q.float(), ksum, kptv, w)
                f32 = (f"; the float32 plain apply is "
                       f"{(y - y32).abs().max().item():.3e} from the kernel "
                       f"({outside(y, y32)} outside the tolerance) and "
                       f"{(y32 - wy).abs().max().item():.3e} from float64 "
                       f"({outside(y32, wy)} outside)")
                del y32
            print(f"[favor] {list(shape)} {str(dtype)[6:]}: favor_stats "
                  f"max_abs_err {s_err:.3e} (|kptv| max {scale:.4g}, "
                  f"relative {s_err / scale:.3e}) against the float32 plain "
                  f"stats; favor_apply max_abs_err {y_err:.3e} on the "
                  f"kernel's stats, chain {c_err:.3e}, both against the "
                  f"plain versions in {str(wide)[6:]} (rtol {FAVOR_RTOL}, "
                  f"atol {FAVOR_ATOL}); deterministic{f32}")
            if shape == FAVOR_TRAIN and dtype == torch.bfloat16:
                STATS.result["max_abs_err"] = s_err
                APPLY.result["max_abs_err"] = y_err
                # the bf16 stats against float64: at most the mma.sync
                # design's gap (its largest magnitude's share)
                ks64, kv64 = favor_stats_reference(k.double(), v.double(),
                                                   w.double())
                gap = ((kptv.double() - kv64).abs().max()
                       / kv64.abs().max()).item()
                gap32 = ((wkv.double() - kv64).abs().max()
                         / kv64.abs().max()).item()
                print(f"[favor] {list(shape)} bf16: favor_stats kptv off "
                      f"float64 by {gap:.3e} of its largest magnitude "
                      f"(bound {STATS_F64_GAP:.1e}, the mma.sync design's); "
                      f"the float32 plain stats {gap32:.3e}")
                assert gap <= STATS_F64_GAP, gap
                del ks64, kv64
            del q, k, v, ksum, kptv, y, wks, wkv, wy, chain

    # the backward kernels against the closed form in float64, and the
    # autograd.Function's gradients (float32) against autograd through the
    # plain path in float64
    for i, shape in enumerate(BWD_SHAPES):
        for dtype in (torch.float32, torch.bfloat16):
            err = check_favor_backward(shape, dtype, seed=250 + i)
            if shape == FAVOR_TRAIN and dtype == torch.bfloat16:
                FAVOR_BWD.result["max_abs_err"] = err
    shape = (8, VIP_HEADS, VIP_T, VIP_E, VIP_M)
    q, k, v, w = favor_operands(*shape, torch.float32, seed=300)
    g = torch.randn(q.shape, device="cuda")
    leaves = [t.detach().requires_grad_(True) for t in (q, k, v)]
    before = (favor_bwd_q.launches, favor_bwd_kv.launches)
    out = favor_attention_fused(*leaves, w)
    got = torch.autograd.grad((out * g).sum(), leaves)
    assert (favor_bwd_q.launches, favor_bwd_kv.launches) == (
        before[0] + 1, before[1] + 1)
    with torch.no_grad():
        out32 = favor_attention(q, k, v, w)
    torch.testing.assert_close(out, out32, rtol=FAVOR_RTOL, atol=FAVOR_ATOL)
    ref = [t.detach().double().requires_grad_(True) for t in (q, k, v)]
    want_out = favor_attention(*ref, w.double())
    want = torch.autograd.grad((want_out * g.double()).sum(), ref)
    err = max(bwd_excess(a, b) for a, b in zip(got, want))
    print(f"[favor] favor_attention_fused autograd {list(shape[:4])} "
          f"float32: forward max_abs_err {(out - out32).abs().max().item():.3e}"
          f" against favor_attention in float32; gradients {err:.3e} of "
          f"their largest magnitude past rtol {FAVOR_RTOL} from autograd "
          f"through favor_attention in float64 (bound {FAVOR_ATOL})")
    assert err <= FAVOR_ATOL, err
    del q, k, v, g, leaves, out, got, ref, want_out, want

    print("[favor] device times in ms, bf16 q/k/v strided views as the "
          "block passes them, float32 w and outputs; 20 calls in one CUDA "
          "graph, timed by CUDA events; library: none (no single PyTorch "
          "call computes FAVOR+)")
    for b in (64, TRAIN_BATCH):
        shape = (b, VIP_HEADS, VIP_T, VIP_E, VIP_M)
        q, k, v, w = favor_operands(*shape, torch.bfloat16, seed=400 + b)
        ksum, kptv = favor_stats(k, v, w)
        calls = {
            "favor_stats": lambda: favor_stats(k, v, w),
            "favor_stats plain": lambda: favor_stats_reference(k, v, w),
            "favor_apply": lambda: favor_apply(q, ksum, kptv, w),
            "favor_apply plain": lambda: favor_apply_reference(q, ksum, kptv,
                                                               w),
            "kernels": lambda: favor_attention_fused(q, k, v, w),
            "three-einsum path": lambda: favor_attention(q, k, v, w)}
        with torch.no_grad():
            dev = {name: device_ms(fn, iters=20) for name, fn in calls.items()}
        work = favor_work(*shape, in_bytes=2)
        for kern in (STATS, APPLY):
            # each bf16 kernel's design: its bf16x3 products on the tensor
            # cores (TC_PRODUCTS for each 2 m e flops a row); the
            # float32-operation figure beside it
            n_bytes, flops = work[kern.name]
            f32_ms, _ = bound(n_bytes, flops, torch.float32)
            tc_flops = (TC_PRODUCTS[kern.name] * b * VIP_HEADS * VIP_T * 2
                        * VIP_M * VIP_E)
            ms, by = bound(n_bytes, tc_flops, torch.bfloat16)
            what = (f"{n_bytes} B, {tc_flops} bf16x3 tensor-core flop; "
                    f"the float32-operation figure {f32_ms:.6f}")
            print(f"[favor] {kern.name} [{b},4,3137,128] m 64: kernel "
                  f"{dev[kern.name]:.5f} plain {dev[kern.name + ' plain']:.5f}"
                  f" | bound {ms:.6f} ({by}: {what}) | "
                  f"{100 * ms / dev[kern.name]:.1f}% of the bound")
            if b == TRAIN_BATCH:
                kern.result.update(ms=dev[kern.name],
                                   plain_ms=dev[kern.name + " plain"],
                                   bound_ms=ms, bound_by=by, library_ms=None)
        print(f"[favor] [{b},4,3137,128]: the two kernels (stats + apply) "
              f"{dev['kernels']:.5f}, the plain three-einsum path that "
              f"--use_pallas_favor False runs {dev['three-einsum path']:.5f}")
        time_favor_backward(b, q, k, v, w, ksum, kptv, seed=500 + b)
        del q, k, v, ksum, kptv, calls


# the backward kernels' shapes: ViP's training shape, a ragged T with e 72
# and m 16, and e 36 (rows that bulk copies cannot take: plain loads)
BWD_SHAPES = [FAVOR_TRAIN, (1, 3, 1049, 72, 16), (2, 2, 100, 36, 16)]


def bwd_excess(got, want):
    """How far ``got`` lies from the float64 ``want`` past FAVOR_RTOL of
    each element and past half an ulp of ``got``'s dtype (the rounding of
    a bf16 output), in units of ``want``'s largest magnitude: within
    FAVOR_ATOL for a float32-accurate result; a bf16-level one lies 1e-3
    and more past it."""
    slack = FAVOR_RTOL * want.abs()
    if got.dtype == torch.bfloat16:
        _, ex = torch.frexp(want)
        slack = slack + torch.ldexp(torch.ones_like(want), ex - 9)
    return (((got.double() - want).abs() - slack).clamp_min(0).max()
            / want.abs().max()).item()


def check_favor_backward(shape, dtype, seed):
    """favor_bwd_q and favor_bwd_kv on the Performer block's strided views
    and a dy in the apply kernel's [B,T,H,e] layout, against the closed
    form in float64 (dq, dk, dv past their output's rounding; the moments'
    gradients at rtol / atol times their largest magnitude), and bit for
    bit alike on a second run.  Returns dq, dk and dv's largest excess."""
    b, h, t, e, m = shape
    q, k, v, w = favor_operands(*shape, dtype, seed=seed)
    g = torch.randn(b, t, h, e, device="cuda",
                    generator=torch.Generator("cuda").manual_seed(seed))
    dy = g.permute(0, 2, 1, 3)
    ksum, kptv = favor_stats(k, v, w)
    before = (favor_bwd_q.launches, favor_bwd_kv.launches)
    dq, dkptv, dksum = favor_bwd_q(q, dy, ksum, kptv, w)
    dk, dv = favor_bwd_kv(k, v, dkptv, dksum, w)
    torch.cuda.synchronize()
    assert (favor_bwd_q.launches, favor_bwd_kv.launches) == (
        before[0] + 1, before[1] + 1)
    wide = [x.double() for x in (q, k, v, dy, w)]
    ks64, kv64 = favor_stats_reference(wide[1], wide[2], wide[4])
    want = favor_backward_reference(wide[0], wide[1], wide[2], wide[3],
                                    ks64, kv64, wide[4])
    moments = favor_bwd_q_reference(wide[0], wide[3], ks64, kv64,
                                    wide[4])[1:]
    errs = {name: bwd_excess(got, ref)
            for name, got, ref in zip(("dq", "dk", "dv"), (dq, dk, dv), want)}
    off = {name: (got.double() != ref.to(dtype).double()).double()
           .mean().item()
           for name, got, ref in zip(("dq", "dk", "dv"), (dq, dk, dv), want)}
    for got, ref in zip((dkptv, dksum), moments):
        torch.testing.assert_close(
            got.double(), ref, rtol=FAVOR_RTOL,
            atol=FAVOR_ATOL * ref.abs().max().item())
    again = favor_bwd_q(q, dy, ksum, kptv, w)
    same = torch.equal(again[0], dq) and torch.equal(again[1], dkptv)
    again = favor_bwd_kv(k, v, dkptv, dksum, w)
    same = same and torch.equal(again[0], dk) and torch.equal(again[1], dv)
    print(f"[favor] backward {list(shape)} {str(dtype)[6:]}: excess over "
          f"float64 (past rtol {FAVOR_RTOL} and the output's rounding, of "
          f"the largest magnitude) " + ", ".join(
              f"{n} {x:.3e}" for n, x in errs.items())
          + (", outputs off float64's bf16 rounding " + ", ".join(
              f"{n} {100 * x:.2f}%" for n, x in off.items())
             if dtype == torch.bfloat16 else "")
          + f" (bound {FAVOR_ATOL}); deterministic {same}")
    assert max(errs.values()) <= FAVOR_ATOL, errs
    assert same, "the backward kernels are not deterministic"
    return max(errs.values())


def time_favor_backward(b, q, k, v, w, ksum, kptv, seed):
    """The two backward kernels at [b,4,3137,128] bf16 (a dy in the apply
    kernel's layout) beside the plain closed form and autograd's float32
    recompute that the kernels replace; the bound reckoned as
    portbench's favor_bwd_roofline.train reckons it."""
    g = torch.randn(b, VIP_T, VIP_HEADS, VIP_E, device="cuda",
                    generator=torch.Generator("cuda").manual_seed(seed))
    dy = g.permute(0, 2, 1, 3)
    dq, dkptv, dksum = favor_bwd_q(q, dy, ksum, kptv, w)

    def recompute():
        with torch.enable_grad():
            leaves = [t.detach().float().requires_grad_(True)
                      for t in (q, k, v)]
            y = favor_attention(*leaves, w)
            return torch.autograd.grad(y, leaves, dy)

    with torch.no_grad():
        dev = {"kernels": device_ms(
            lambda: favor_bwd_kv(k, v, *favor_bwd_q(q, dy, ksum, kptv,
                                                   w)[1:], w), iters=20),
               "q pass": device_ms(lambda: favor_bwd_q(q, dy, ksum, kptv, w),
                                   iters=20),
               "k, v pass": device_ms(
                   lambda: favor_bwd_kv(k, v, dkptv, dksum, w), iters=20),
               "plain": device_ms(lambda: favor_backward_reference(
                   q, k, v, dy, ksum, kptv, w), iters=5)}
    start = torch.cuda.Event(enable_timing=True)
    end = torch.cuda.Event(enable_timing=True)
    recompute()
    start.record()
    for _ in range(5):
        recompute()
    end.record()
    end.synchronize()
    dev["recompute"] = start.elapsed_time(end) / 5
    rows = b * VIP_HEADS * VIP_T
    n_bytes = (rows * VIP_E * (3 * 2 + 4 + 3 * 2) + VIP_M * VIP_E * 4
               + b * VIP_HEADS * (VIP_M + VIP_M * VIP_E) * 4)
    ms, by = bound(n_bytes, 8 * 2 * VIP_M * VIP_E * rows)
    print(f"[favor] favor_bwd [{b},4,3137,128] m 64 bf16: kernels "
          f"{dev['kernels']:.5f} (q pass {dev['q pass']:.5f}, k, v pass "
          f"{dev['k, v pass']:.5f}) plain {dev['plain']:.5f} | bound "
          f"{ms:.6f} ({by}: {n_bytes} B, the eight products' "
          f"{16 * VIP_M * VIP_E * rows} flop) | {100 * ms / dev['kernels']:.1f}%"
          f" of the bound; autograd's float32 recompute it replaces "
          f"{dev['recompute']:.5f} (events over 5 calls)")
    if b == TRAIN_BATCH:
        FAVOR_BWD.result.update(ms=dev["kernels"], plain_ms=dev["plain"],
                                bound_ms=ms, bound_by=by, library_ms=None)


def plain_favor(q, k, v, w):
    """FAVOR+ through the kernels' plain float32 versions, on the card."""
    return favor_apply_reference(q, *favor_stats_reference(k, v, w), w)


def plain_favor_inside():
    """Substitute the plain float32 FAVOR+ for the kernel wrapper in the
    Performer blocks (a comparison of this script, not a package
    option)."""
    return patched(performer, "favor_attention_fused", plain_favor)


def compare(tag, pairs):
    """(what, got, want, bound or None for BF16_REL * max|want|)."""
    failed = []
    for what, got, want, bnd in pairs:
        if bnd is None:
            bnd = BF16_REL * float(np.abs(want).max())
        diff = float(np.abs(got - want).max())
        print(f"[{tag}] {what}: max abs diff {diff:.4e} (bound {bnd:.4e})")
        if not diff <= bnd:
            failed.append(what)
    assert not failed, failed


def phase_vip_serve(rng):
    t0 = time.perf_counter()
    pred = HandPosePredictor.from_checkpoint(VIP, image_size=IMAGE)
    model = pred.model
    assert isinstance(model, performer.ViP)
    assert model.tokens == VIP_T and model.emb == VIP_HEADS * VIP_E
    assert len(model.mains) == 3 and all(b.use_kernel for b in model.mains)
    block = model.mains[0]
    assert block.w.shape == (VIP_M, VIP_E) and block.w.dtype == torch.float32
    assert block.kqv.weight.dtype == torch.bfloat16
    assert block.ln1.weight.dtype == torch.float32
    assert model.head.weight.dtype == torch.float32
    print(f"[vip-serve] predictor built in {time.perf_counter() - t0:.1f} s "
          f"(224 px, {VIP_T} tokens x {model.emb}, {VIP_HEADS} heads, depth "
          f"3, m {VIP_M}, iteration 3, bf16, FAVOR+ kernels); buckets "
          f"{pred._buckets}")
    t0 = time.perf_counter()
    pred.warmup()
    print(f"[vip-serve] warmup of every bucket, uint8 and float32: "
          f"{time.perf_counter() - t0:.1f} s")

    crops = {n: rng.randint(0, 256, (n, IMAGE, IMAGE, 3)).astype(np.uint8)
             for n in REQUESTS}
    big = pred._buckets[-1]
    reset_counts()
    outs = {n: pred.predict(crops[n]) for n in REQUESTS}
    st, ap = favor_stats.launches, favor_apply.launches
    chunks = sum(n_chunks(n, big) for n in REQUESTS)
    STATS.result["launches"] += st
    APPLY.result["launches"] += ap
    print(f"[vip-serve] requests {list(REQUESTS)} uint8: {chunks} forward "
          f"chunks, favor_stats launches {st}, favor_apply launches {ap}, "
          f"attention launches {flash_attention.launches} + "
          f"{attention_bwd.launches}")
    assert st == 3 * chunks and ap == 3 * chunks, (st, ap, chunks)
    assert flash_attention.launches == 0 and attention_bwd.launches == 0
    for n, out in outs.items():
        check_output(out, n, root_centred=False)
    j = outs[64]["joints_3d"]
    print(f"[vip-serve] outputs finite, of the right shapes; |joints_3d| "
          f"max {np.abs(j).max():.4f}, joint 1 of crop 0 {j[0, 1]}")

    # bf16: the same model with the plain float32 FAVOR+ in the blocks
    with plain_favor_inside():
        out_sub = pred.predict(crops[64])
    assert favor_stats.launches == st, "the substitution launched"
    pairs = [(f"bf16 kernels vs plain float32 FAVOR+, 64 crops, {k}",
              outs[64][k], out_sub[k], None) for k in out_sub]
    # float32: the kernel path against the plain path, same seed
    f32 = dataclasses.replace(VIP, compute_dtype="float32")
    o32 = HandPosePredictor.from_checkpoint(f32, image_size=IMAGE).predict(
        crops[7])
    o32_plain = HandPosePredictor.from_checkpoint(
        dataclasses.replace(f32, use_pallas_favor=False),
        image_size=IMAGE).predict(crops[7])
    pairs += [(f"float32 kernels vs plain FAVOR+ path, 7 crops, {k}",
               o32[k], o32_plain[k],
               F32_ATOL * (IMAGE / 2 if k == "joints_2d" else 1))
              for k in ("camera", "joints_3d", "joints_2d")]
    compare("vip-serve", pairs)
    # bf16 against --use_pallas_favor False (printed: that path rounds
    # |x|^2 to bf16, the kernels do not)
    out_plain = HandPosePredictor.from_checkpoint(
        dataclasses.replace(VIP, use_pallas_favor=False),
        image_size=IMAGE).predict(crops[64])
    diff = float(np.abs(outs[64]["joints_3d"] - out_plain["joints_3d"]).max())
    print(f"[vip-serve] bf16 kernels vs --use_pallas_favor False, 64 crops, "
          f"joints_3d: max abs diff {diff:.4e} (|joints_3d| max "
          f"{np.abs(out_plain['joints_3d']).max():.4f})")

    serving_rate("vip-serve", pred, rng, VIP_WINDOW_REQUESTS,
                 VIP_WINDOW_CROPS)


def phase_vip_train(rng):
    t0 = time.perf_counter()
    trainer = Trainer(VIP_TRAIN, image_size=IMAGE)
    state, model = trainer.state, trainer.model
    assert isinstance(model, performer.ViP) and not model.remat
    assert all(b.use_kernel for b in model.mains) and model.dropout == 0.1
    assert all(p.dtype == torch.float32 for p in model.parameters())
    assert model.compute_dtype == torch.bfloat16
    print(f"[vip-train] trainer built in {time.perf_counter() - t0:.1f} s "
          f"(ViP, bs {VIP_TRAIN.batch_size}, {IMAGE}x{IMAGE}, {VIP_T} tokens "
          f"x {model.emb}, dropout 0.1, bf16 compute, float32 parameters)")
    log = os.path.join(VIP_TRAIN.checkpoint_folder, "metrics.csv")
    if os.path.exists(log):
        os.remove(log)
    n_steps = VIP_TRAIN.epoch * VIP_TRAIN.steps_per_epoch
    reset_counts()
    t0 = time.perf_counter()
    trainer.train()
    st, ap = favor_stats.launches, favor_apply.launches
    bq, bkv = favor_bwd_q.launches, favor_bwd_kv.launches
    print(f"[vip-train] {VIP_TRAIN.epoch} epochs x "
          f"{VIP_TRAIN.steps_per_epoch} steps in "
          f"{time.perf_counter() - t0:.1f} s (first steps and saves "
          f"included); favor_stats launches {st}, favor_apply launches {ap}, "
          f"favor_bwd_q {bq}, favor_bwd_kv {bkv}")
    STATS.result["launches"] += st
    APPLY.result["launches"] += ap
    FAVOR_BWD.result["launches"] += bq
    assert st == 3 * n_steps and ap == 3 * n_steps, (st, ap, n_steps)
    assert bq == bkv == 3 * n_steps, (bq, bkv, n_steps)
    assert flash_attention.launches == 0 and attention_bwd.launches == 0
    with open(log) as f:
        losses = [float(r["loss"]) for r in csv.DictReader(f)]
    assert len(losses) == n_steps and np.isfinite(losses).all(), losses
    quarter = n_steps // 4
    first, last = np.mean(losses[:quarter]), np.mean(losses[-quarter:])
    print(f"[vip-train] loss: mean of the first {quarter} steps {first:.1f}, "
          f"of the last {quarter} {last:.1f}")
    assert last < first, (first, last)

    # one step's loss and gradients from the same weights, batch and
    # dropout masks: kernels, the plain float32 FAVOR+, and remat
    batches = list(trainer.train_loader)[:2]
    batch = batches[0]
    inputs = model.train_inputs(VIP_TRAIN.batch_size,
                                torch.Generator("cuda").manual_seed(5))

    def loss_and_grads():
        model.zero_grad(set_to_none=True)
        bd = steps.forward_loss(model, batch["image"], batch["label"],
                                batch["valid"], VIP_TRAIN.l_weight_3d,
                                VIP_TRAIN.l_weight_2d, **inputs)[0]
        bd.total.backward()
        grads = [p.grad.detach().clone() for p in model.parameters()]
        norm = torch.sqrt(sum((g.float() ** 2).sum() for g in grads))
        return bd.total.item(), norm.item(), grads

    reset_counts()
    loss_k, norm_k, grads_k = loss_and_grads()
    assert (favor_stats.launches, favor_apply.launches) == (3, 3)
    assert (favor_bwd_q.launches, favor_bwd_kv.launches) == (3, 3)
    with plain_favor_inside():
        loss_p, norm_p, _ = loss_and_grads()
    assert (favor_stats.launches, favor_apply.launches) == (3, 3), \
        "the plain substitution launched"
    failed = []
    for what, got, want in (("loss", loss_k, loss_p),
                            ("global gradient norm", norm_k, norm_p)):
        diff, bnd = abs(got - want), BF16_REL * abs(want)
        print(f"[vip-train] bf16 kernels vs plain float32 FAVOR+, one step, "
              f"{what}: {got:.6g} vs {want:.6g}, diff {diff:.4e} (bound "
              f"{bnd:.4e})")
        if not diff <= bnd:
            failed.append(what)
    assert not failed, failed
    model.remat = True
    reset_counts()
    loss_r, norm_r, grads_r = loss_and_grads()
    launches = (favor_stats.launches, favor_apply.launches,
                favor_bwd_q.launches, favor_bwd_kv.launches)
    model.remat = False
    model.zero_grad(set_to_none=True)
    rel = max(((a - b).abs().max() / b.abs().max().clamp(min=1e-30)).item()
              for a, b in zip(grads_r, grads_k))
    print(f"[vip-train] remat_blocks vs none, one step: loss {loss_r:.6g} vs "
          f"{loss_k:.6g}, gradient norm {norm_r:.6g} vs {norm_k:.6g}, "
          f"largest gradient difference {rel:.3e} of the tensor's largest "
          f"entry (bound 1e-5); launches {launches}")
    assert launches == (6, 6, 3, 3), launches
    assert loss_r == loss_k and rel <= 1e-5, (loss_r, loss_k, rel)
    del grads_k, grads_r

    # the final checkpoint, served as it is
    path = checkpoint.save_state(VIP_TRAIN.checkpoint_folder, state,
                                 checkpoint.FINAL_NAME)
    crops = rng.randint(0, 256, (8, IMAGE, IMAGE, 3)).astype(np.uint8)
    served = HandPosePredictor.from_checkpoint(
        dataclasses.replace(VIP_TRAIN, checkpoint_path_eval=path),
        image_size=IMAGE)
    got = served.predict(crops)
    check_output(got, 8, root_centred=False)
    mirror = HandPosePredictor(
        model=copy.deepcopy(model).cast_compute(torch.bfloat16),
        image_size=IMAGE)
    for k, v in mirror.predict(crops).items():
        np.testing.assert_array_equal(got[k], v, err_msg=k)
    del served, mirror
    got32 = HandPosePredictor.from_checkpoint(
        dataclasses.replace(VIP_TRAIN, checkpoint_path_eval=path,
                            compute_dtype="float32"),
        image_size=IMAGE).predict(crops)
    model.eval().set_compute_dtype(torch.float32)
    with torch.no_grad():
        x = torch.from_numpy(crops).cuda().float() / 127.5 - 1.0
        want = model(x.permute(0, 3, 1, 2))[0][:, 3:].reshape(-1, 21, 3)
    model.train().set_compute_dtype(torch.bfloat16)
    diff = float(np.abs(got32["joints_3d"] - want.cpu().numpy()).max())
    print(f"[vip-train] {path} served by HandPosePredictor: bf16 predict "
          f"equals the trained model's; float32 predict vs the trained "
          f"model's float32 eval forward, joints_3d max abs diff {diff:.4e} "
          f"(bound {F32_ATOL})")
    assert diff <= F32_ATOL, diff

    step = trainer.train_step
    for i in range(3):
        step(state, batches[i % 2])
    torch.cuda.synchronize()
    window = 10
    t0 = time.perf_counter()
    for i in range(window):
        step(state, batches[i % 2])
    torch.cuda.synchronize()
    dt = time.perf_counter() - t0
    times = []
    for i in range(10):
        t1 = time.perf_counter()
        step(state, batches[i % 2])
        torch.cuda.synchronize()
        times.append(time.perf_counter() - t1)
    p50 = float(np.median(times)) * 1e3
    print(f"[vip-train] rate: {window} steps of {VIP_TRAIN.batch_size} crops "
          f"in {dt * 1e3:.1f} ms: {window * VIP_TRAIN.batch_size / dt:.1f} "
          f"crops/s; p50 step time {p50:.3f} ms (10 steps, each "
          f"synchronised); peak memory "
          f"{torch.cuda.max_memory_allocated() / 2**30:.1f} GiB; card "
          f"{card_line()}")

    def three_steps():
        for i in range(3):
            step(state, batches[i % 2])
        torch.cuda.synchronize()

    busy, _ = device_profile("vip-train", three_steps, f"3 train steps of "
                             f"{VIP_TRAIN.batch_size} crops")
    print(f"[vip-train] device busy {busy / 3:.3f} ms per step against the "
          f"p50 step time {p50:.3f} ms: device idle "
          f"{100 * (1 - busy / 3 / p50):.1f}% of an unprofiled step")
    return model, path


def phase_vip_eval(model, path):
    """The Evaluator on vip-train's hand_net_final.pth, synthetic batches:
    the FAVOR+ kernels 3 + 3 times a batch, and the file's frozen
    projections mains.{i}.w (the options' seed differs from training's,
    so a fresh draw would not be the trained model's)."""
    opt = dataclasses.replace(
        VIP_TRAIN, checkpoint_path_eval=path, synthetic_data=True,
        steps_per_epoch=2, seed=1,
        result_dir=os.path.join("build", "chip_smoke_vip_eval"))
    ev = Evaluator(opt, image_size=IMAGE)
    reset_counts()
    t0 = time.perf_counter()
    result = ev.eval()
    dt = time.perf_counter() - t0
    st, ap = favor_stats.launches, favor_apply.launches
    print(f"[vip-eval] Evaluator on {path}, 2 synthetic batches of "
          f"{opt.batch_size} in {dt * 1e3:.1f} ms: "
          f"{2 * opt.batch_size / dt:.1f} crops/s; favor_stats launches "
          f"{st}, favor_apply launches {ap}; MPJPE "
          f"{result['mpjpe_mm']:.3f} mm, AUC {result['auc']:.4f}")
    assert st == 3 * 2 and ap == 3 * 2, (st, ap)
    assert flash_attention.launches == 0 and attention_bwd.launches == 0
    STATS.result["launches"] += st
    APPLY.result["launches"] += ap
    assert np.isfinite(result["mpjpe_mm"]) and np.isfinite(result["auc"])
    fresh = performer.ViP(mean_params=model.mean_params.cpu(),
                          image_pix=IMAGE, iteration=3)
    checkpoint.init_weights(fresh, seed=opt.seed)
    for i, (mine, trained) in enumerate(zip(ev.model.mains, model.mains)):
        assert torch.equal(mine.w, trained.w), i
        assert not torch.equal(mine.w.cpu(), fresh.mains[i].w), i
    print("[vip-eval] the loaded mains.{i}.w equal the trained model's (a "
          "fresh draw of the options' seed does not)")


def _post(port, arr):
    conn = http.client.HTTPConnection("127.0.0.1", port, timeout=300)
    conn.request("POST", "/predict", body=arr.tobytes(), headers={
        "X-Shape": ",".join(map(str, arr.shape)),
        "X-Dtype": str(arr.dtype)})
    resp = conn.getresponse()
    body = json.loads(resp.read())
    assert resp.status == 200, (resp.status, body)
    return {k: np.asarray(v, np.float32) for k, v in body.items()}


def phase_serve(pred, crops, tag="serve"):
    """POST /predict (also micro-batched) answers exactly what predict
    returns, for crops[7] (uint8 and float32) and crops[1]; GET
    /healthz."""
    servers = [make_server(pred, "127.0.0.1", 0),
               make_server(pred, "127.0.0.1", 0, batch_window_ms=5.0)]
    threads = [threading.Thread(target=s.serve_forever, daemon=True)
               for s in servers]
    for t in threads:
        t.start()
    try:
        ports = [s.server_address[1] for s in servers]
        as_float = crops[7].astype(np.float32) / 127.5 - 1.0
        sent = [(ports[0], crops[7]), (ports[0], as_float),
                (ports[1], crops[1])]
        for port, body in sent:
            got = _post(port, body)
            want = pred.predict(body)
            for k in want:
                np.testing.assert_allclose(got[k], want[k], rtol=1e-6,
                                           atol=1e-6, err_msg=k)
            print(f"[{tag}] POST /predict {list(body.shape)} "
                  f"{body.dtype} on port {port}: equals predict")
        conn = http.client.HTTPConnection("127.0.0.1", ports[0], timeout=60)
        conn.request("GET", "/healthz")
        resp = conn.getresponse()
        health = json.loads(resp.read())
        assert resp.status == 200 and health["status"] == "ok", health
        assert health["image_size"] == IMAGE, health
        print(f"[{tag}] GET /healthz: {health}")
        batcher = servers[1].RequestHandlerClass.predictor
        assert batcher.requests_served == 1, batcher.requests_served
    finally:
        for s in servers:
            s.shutdown()
            s.server_close()
        for t in threads:
            t.join(timeout=10)
    assert not any(t.is_alive() for t in threads), "server thread alive"


# the export phase's artifacts go to build/, which .gitignore lists
EXPORT_ROOT = os.path.join("build", "chip_smoke_export")
REPO_ROOT = os.path.dirname(os.path.abspath(__file__))
# host-side ops that run a model layer eagerly: a profile of a replayed
# request holds none of them
EAGER_LAYER_OPS = ("aten::conv2d", "aten::convolution", "aten::linear",
                   "aten::batch_norm", "aten::layer_norm", "aten::addmm",
                   "aten::mm", "aten::bmm", "aten::matmul",
                   "scat_tpu_torch::attention_fwd",
                   "scat_tpu_torch::favor_stats",
                   "scat_tpu_torch::favor_apply")
# a fresh process serves an artifact with no model module of the port
# imported
SERVE_WITHOUT_MODELS = """
import sys
import numpy as np
from scat_tpu_torch.export import ExportedPredictor
p = ExportedPredictor(sys.argv[1])
out = p.predict(np.zeros((3, p.image_size, p.image_size, 3), np.uint8))
bad = [m for m in sys.modules if m.startswith("scat_tpu_torch.models")]
assert not bad, bad
assert all(np.isfinite(v).all() for v in out.values())
print("a fresh process served 3 crops, no scat_tpu_torch.models module "
      "imported:", {k: v.shape for k, v in out.items()})
"""


def port_env():
    return dict(os.environ, PYTHONPATH=REPO_ROOT, PYTHONUNBUFFERED="1")


def export_and_load(tag, pred, path, net):
    """export_predictor to ``path``, then ExportedPredictor from it, each
    timed; the artifact's files and size printed."""
    t0 = time.perf_counter()
    export_predictor(pred, path, net=net)
    dt = time.perf_counter() - t0
    files = {f: os.path.getsize(os.path.join(path, f))
             for f in sorted(os.listdir(path))}
    print(f"[{tag}] exported {net} ({pred.model.compute_dtype}) in "
          f"{dt:.1f} s: {sum(files.values()) / 1e6:.1f} MB "
          f"{ {f: round(b / 1e6, 1) for f, b in files.items()} }")
    t0 = time.perf_counter()
    art = ExportedPredictor(path)
    print(f"[{tag}] loaded in {time.perf_counter() - t0:.1f} s: manifest "
          f"{art.manifest}")
    return art


def load_without_models(tag, path):
    out = subprocess.run([sys.executable, "-c", SERVE_WITHOUT_MODELS, path],
                         cwd=REPO_ROOT, env=port_env(), capture_output=True,
                         text=True, timeout=600)
    assert out.returncode == 0, out.stdout[-2000:] + out.stderr[-4000:]
    print(f"[{tag}] {out.stdout.strip()}")


def check_nodes(tag, art, want):
    for name, module in art.programs.items():
        got = op_nodes(module)
        print(f"[{tag}] {name} program: scat_tpu_torch op nodes {got}")
        assert got == want, (name, got, want)


def replayed(art):
    """By kernel, the launches the replays of ``art``'s CUDA graphs ran
    (the runners' tally: each replay runs what its capture counted)."""
    tally = collections.Counter()
    for runner in art._forwards.values():
        tally.update(runner.replayed)
    return {k.name: tally[k.wrapper.__name__] for k in KERNELS}


def check_captures(tag, art, per_forward):
    """``warmup`` captures one graph per (bucket, dtype) and replays it
    once; each capture and its eager warm-up run count ``per_forward``
    launches of each kernel, which are added to the kernels' launches,
    and the replay adds as many to the runners' tally."""
    reset_counts()
    before = replayed(art)
    t0 = time.perf_counter()
    art.warmup()
    dt = time.perf_counter() - t0
    keys = sum(len(r.keys) for r in art._forwards.values())
    assert keys == 2 * len(art._buckets), keys
    counts = {k.name: k.wrapper.launches for k in KERNELS}
    replays = {k: n - before[k] for k, n in replayed(art).items()}
    for k in KERNELS:
        k.result["launches"] += k.wrapper.launches
    print(f"[{tag}] warmup captured {keys} graphs (buckets "
          f"{art._buckets} x uint8, float32) in {dt:.1f} s; launches "
          f"counted {counts}: {per_forward} in each capture and in its "
          f"eager warm-up run; replayed {replays}")
    assert counts == {k.name: 2 * keys * per_forward.get(k.name, 0)
                      for k in KERNELS}, counts
    assert replays == {k.name: keys * per_forward.get(k.name, 0)
                       for k in KERNELS}, replays


def replayed_profile(tag, art, x, big, per_chunk):
    """torch.profiler over one replayed request of ``x``: each kernel of
    ``per_chunk`` (profile key -> device kernels a chunk) runs that many
    times a chunk, one graph launch a chunk, and no model layer launches
    eagerly; the counters count no replay, and the runners' tally adds
    as many launches as the profile counts kernels.  Returns
    device_profile's (busy ms, busy %)."""
    chunks = n_chunks(x.shape[0], big)
    reset_counts()
    before = replayed(art)

    def check(events):
        device = [e for e in events
                  if e.device_type == torch.autograd.DeviceType.CUDA]
        for key, n in per_chunk.items():
            got = sum(e.count for e in device if key in e.key)
            print(f"[{tag}] replayed {x.shape[0]} crops: {got} device "
                  f"kernels named {key!r} ({chunks} chunks)")
            assert got == n * chunks, (key, got, n * chunks)
        graphs = sum(e.count for e in events if e.key == "cudaGraphLaunch")
        eager = sorted({e.key for e in events if e.key in EAGER_LAYER_OPS})
        print(f"[{tag}] cudaGraphLaunch x{graphs}; eager layer ops on the "
              f"host: {eager or 'none'}")
        assert graphs == chunks and not eager, (graphs, eager)

    busy = device_profile(tag, lambda: art.predict(x),
                          f"artifact, {x.shape[0]} crops in chunks of {big}",
                          check=check)
    counts = {k.name: k.wrapper.launches for k in KERNELS}
    assert not any(counts.values()), counts
    replays = {k: n - before[k] for k, n in replayed(art).items()}
    print(f"[{tag}] replayed {x.shape[0]} crops: runners' tally {replays}")
    assert replays == {k.name: chunks * per_chunk.get(k.name, 0)
                       for k in KERNELS}, replays
    return busy


def serving_pair(tag, live, art, rng, requests, crops, per_chunk):
    """The live predictor and the artifact on the same weights and the
    same window of back-to-back uint8 requests, in turns (live,
    artifact, artifact, live): crops/s; the p50 request latency at
    buckets 1 and 64 (20 requests each, in turns); the device busy and
    idle share of one 256-crop request (the artifact's through
    replayed_profile)."""
    big = art._buckets[-1]
    window = [rng.randint(0, 256, (crops, IMAGE, IMAGE, 3), dtype=np.uint8)
              for _ in range(requests)]
    preds = {"live": live, "artifact": art}
    for p in preds.values():
        p.predict(window[0])
    n = requests * crops
    for name in ("live", "artifact", "artifact", "live"):
        t0 = time.perf_counter()
        for x in window:
            preds[name].predict(x)
        dt = time.perf_counter() - t0
        print(f"[{tag}] {name:8s} end to end: {requests} back-to-back "
              f"requests of {crops} uint8 crops, {n} crops in "
              f"{dt * 1e3:.1f} ms: {n / dt:.1f} crops/s")
    for b in (1, big):
        x = rng.randint(0, 256, (b, IMAGE, IMAGE, 3), dtype=np.uint8)
        times = {name: [] for name in preds}
        for _ in range(20):
            for name, p in preds.items():
                t0 = time.perf_counter()
                p.predict(x)
                times[name].append(time.perf_counter() - t0)
        print(f"[{tag}] bucket {b:2d}: p50 request latency " + ", ".join(
            f"{name} {np.median(t) * 1e3:.3f} ms"
            for name, t in times.items()) + " (20 requests each)")
    x = window[1][:256]
    device_profile(tag, lambda: live.predict(x),
                   f"live, 256 crops in chunks of {big}")
    replayed_profile(tag, art, x, big, per_chunk)


def serve_artifact_http(tag, art, path, crops):
    """``python -m scat_tpu_torch.server --serve_artifact`` in a process
    of its own answers POST /predict with exactly what the artifact's
    predict returns, and names the artifact in GET /healthz."""
    proc = subprocess.Popen(
        [sys.executable, "-m", "scat_tpu_torch.server", "--serve_artifact",
         path, "--server_host", "127.0.0.1", "--server_port", "0"],
        cwd=REPO_ROOT, env=port_env(), stdout=subprocess.PIPE,
        stderr=subprocess.STDOUT, text=True)
    # a server that never comes up is killed, which ends the read below
    deadline = threading.Timer(600, proc.kill)
    deadline.start()
    try:
        port, lines = None, []
        for line in proc.stdout:
            lines.append(line)
            if line.startswith("serving on http://"):
                port = int(line.split()[2].rsplit(":", 1)[1])
                break
        deadline.cancel()
        assert port is not None, "".join(lines)[-4000:]
        as_float = crops[7].astype(np.float32) / 127.5 - 1.0
        for body in (crops[7], as_float, crops[1]):
            got = _post(port, body)
            want = art.predict(body)
            for k in want:
                np.testing.assert_allclose(got[k], want[k], rtol=1e-6,
                                           atol=1e-6, err_msg=k)
            print(f"[{tag}] scat_tpu_torch.server --serve_artifact: POST "
                  f"/predict {list(body.shape)} {body.dtype} equals "
                  f"predict")
        conn = http.client.HTTPConnection("127.0.0.1", port, timeout=60)
        conn.request("GET", "/healthz")
        health = json.loads(conn.getresponse().read())
        assert health["source"] == f"artifact:{path}", health
        print(f"[{tag}] GET /healthz: {health}")
    finally:
        deadline.cancel()
        proc.terminate()
        proc.wait(timeout=60)


def artifact_vs_live(tag, art, live, requests, bound=None, as_float=None):
    """(what, got, want, bound) pairs of the artifact against the live
    predictor on uint8 requests and one float32 request."""
    pairs = []
    for n, x in requests.items():
        got, want = art.predict(x), live.predict(x)
        check_output(got, n, root_centred=False)
        pairs += [(f"artifact vs live, {n} uint8 crops, {k}", got[k],
                   want[k], bound and bound[k]) for k in want]
    if as_float is not None:
        got, want = art.predict(as_float), live.predict(as_float)
        pairs += [(f"artifact vs live, {len(as_float)} float32 crops, {k}",
                   got[k], want[k], bound and bound[k]) for k in want]
    return pairs


def phase_export(rng):
    """The flagship and ViP at full width served from artifacts written
    by export_predictor (one CUDA graph per bucket and request dtype)
    beside the live predictors on the same weights."""
    crops = {n: rng.randint(0, 256, (n, IMAGE, IMAGE, 3)).astype(np.uint8)
             for n in REQUESTS}
    as_float = crops[7].astype(np.float32) / 127.5 - 1.0
    # float32: 1e-4 of the joints (and of their pixels, 112 per unit)
    f32_bound = {"camera": 1e-4, "joints_3d": 1e-4,
                 "joints_2d": 1e-4 * IMAGE / 2}

    live = HandPosePredictor.from_checkpoint(FLAGSHIP, image_size=IMAGE)
    path = os.path.join(EXPORT_ROOT, "flagship")
    art = export_and_load("export", live, path, FLAGSHIP.net)
    f32 = dataclasses.replace(FLAGSHIP, compute_dtype="float32")
    live32 = HandPosePredictor.from_checkpoint(f32, image_size=IMAGE)
    art32 = export_and_load("export", live32,
                            os.path.join(EXPORT_ROOT, "flagship_f32"),
                            FLAGSHIP.net)
    load_without_models("export", path)
    check_nodes("export", art, {"attention_fwd": 3})
    check_nodes("export", art32, {"attention_fwd": 3})
    check_captures("export", art, {"attention_fwd": 3})
    pairs = artifact_vs_live("export", art, live, crops, as_float=as_float)
    pairs += artifact_vs_live("export", art32, live32, {7: crops[7]},
                              f32_bound, as_float)
    compare("export", pairs)
    del art32, live32
    serving_pair("export", live, art, rng, WINDOW_REQUESTS, WINDOW_CROPS,
                 {"attention_fwd": 3})
    serve_artifact_http("export", art, path, crops)
    del art, live
    torch.cuda.empty_cache()

    live = HandPosePredictor.from_checkpoint(VIP, image_size=IMAGE)
    path = os.path.join(EXPORT_ROOT, "vip")
    art = export_and_load("export-vip", live, path, VIP.net)
    check_nodes("export-vip", art, {"favor_stats": 3, "favor_apply": 3})
    check_captures("export-vip", art, {"favor_stats": 3, "favor_apply": 3})
    compare("export-vip", artifact_vs_live(
        "export-vip", art, live, {n: crops[n] for n in (1, 7, 64)}))
    serving_pair("export-vip", live, art, rng, VIP_WINDOW_REQUESTS,
                 VIP_WINDOW_CROPS, {"favor_stats": 3, "favor_apply": 3})


def free_port() -> int:
    import socket
    with socket.socket() as sock:
        sock.bind(("127.0.0.1", 0))
        return sock.getsockname()[1]


# a train step's loss after the first: Adam's first update is lr *
# sign(g), and a near-zero gradient whose bf16 round-off differs flips
# its weight's step, so later losses drift (1.6% at step 2 under DDP on an
# H100 80GB HBM3 at 700 W); the first step, on the same weights, is held
# at 1e-3
LATER_STEP_REL = 5e-2


def grad_norm(model) -> float:
    """The global gradient norm of ``model``, FSDP's shards gathered."""
    total = 0.0
    for p in model.parameters():
        if p.grad is not None:
            g = p.grad.full_tensor() if hasattr(p.grad, "full_tensor") \
                else p.grad
            total += float(g.float().square().sum())
    return total ** 0.5


def train_losses(trainer, batches, shard=lambda b: b):
    """(losses, the first step's gradient norm, the mean ms of the steps
    after the first, each synchronised) of train steps on ``batches``."""
    losses, norm, ms = [], None, []
    for b in batches:
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        losses.append(float(trainer.train_step(trainer.state,
                                               shard(b))["loss"]))
        ms.append((time.perf_counter() - t0) * 1e3)
        if norm is None:
            norm = grad_norm(trainer.state.model)
    return losses, norm, float(np.mean(ms[1:]))


def mesh_steps(tag, opt, batches, want):
    """3 train steps of the Trainer of ``opt`` on ``batches`` (this rank's
    rows of each, the whole batch at world 1): 3 + 3 attention launches
    a step; the first step's loss within 1e-3 and its gradient norm
    within BF16_REL of the plain trainer's on the same weights, the later
    losses within LATER_STEP_REL."""
    from scat_tpu_torch.parallel.mesh import shard_batch
    trainer = Trainer(opt, image_size=IMAGE)
    assert trainer.mesh is not None and trainer.state.mesh is not None
    reset_counts()
    got, norm, ms = train_losses(trainer, batches,
                                 lambda b: shard_batch(trainer.mesh, b))
    fwd, bwd = flash_attention.launches, attention_bwd.launches
    want_losses, want_norm, want_ms = want
    gaps = [abs(g - w) / abs(w) for g, w in zip(got, want_losses)]
    norm_gap = abs(norm - want_norm) / want_norm
    print(f"[parallel] {tag}: {ms:.1f} ms a step after the first (the "
          f"plain trainer's {want_ms:.1f}, x{ms / want_ms:.2f}); "
          f"losses {[round(x, 3) for x in got]} against the plain "
          f"trainer's {[round(x, 3) for x in want_losses]} (relative gaps "
          f"{', '.join(f'{g:.2e}' for g in gaps)}); first step's gradient "
          f"norm {norm:.4f} against {want_norm:.4f} ({norm_gap:.2e}); "
          f"attention_fwd launches {fwd}, attention_bwd {bwd}")
    assert fwd == bwd == 3 * len(batches), (fwd, bwd)
    assert gaps[0] <= 1e-3 and norm_gap <= BF16_REL, (gaps, norm_gap)
    assert max(gaps[1:]) <= LATER_STEP_REL, gaps
    FWD.result["launches"] += fwd
    BWD.result["launches"] += bwd
    step_profile(f"parallel {tag}", trainer,
                 lambda: shard_batch(trainer.mesh, batches[0]))


def step_profile(tag, trainer, batch_fn):
    """One more train step under torch.profiler: the device's busy and
    idle share, and the host's side: the collectives issued and the
    host operations that take the most self time."""
    counts = {}

    def host(events):
        top = sorted((e for e in events
                      if e.device_type == torch.autograd.DeviceType.CPU),
                     key=lambda e: -e.self_cpu_time_total)[:6]
        counts["collectives"] = sum(
            e.count for e in events
            if e.device_type == torch.autograd.DeviceType.CPU
            and e.key.startswith(("c10d::", "nccl:")))
        counts["top"] = [(e.key[:40], e.count,
                          round(e.self_cpu_time_total / 1e3, 3))
                         for e in top]

    def step():
        trainer.train_step(trainer.state, batch_fn())
        torch.cuda.synchronize()

    step()
    device_profile(tag, step, "one train step", host)
    print(f"[{tag}] host: {counts['collectives']} collective calls; top "
          f"self-time host ops (name, calls, ms) {counts['top']}")


def vip_loss(model, x, mesh=None, microbatches=2):
    """The surrogate pred.float().square().mean() of ViP on ``x``, its
    blocks run in sequence or through pipeline_apply over ``mesh``."""
    from scat_tpu_torch.parallel import pipeline
    with model._autocast("cuda"):
        tok = model.embed(x)
        if mesh is None:
            for block in model.mains:
                tok = block(tok)
        else:
            tok = pipeline.pipeline_apply(lambda blk, t: blk(t), model.mains,
                                          tok, mesh, microbatches)
    return model.readout(tok)[0].float().square().mean()


def vip_pipeline_step(rng, mesh):
    """ViP at full width through pipeline_apply at pipe:1 for one step
    (2 microbatches of 16): 3 + 3 FAVOR+ launches a microbatch, the loss
    and the gradient norm within BF16_REL of the blocks in sequence."""
    model, _ = build_model(VIP, IMAGE)
    checkpoint.init_weights(model, seed=0)
    model = model.cuda().train().set_compute_dtype(torch.bfloat16)
    x = torch.from_numpy(rng.uniform(-1, 1, (32, 3, IMAGE, IMAGE)).astype(
        np.float32)).cuda()
    out = {}
    for name, m in (("sequence", None), ("pipeline", mesh)):
        model.zero_grad(set_to_none=True)
        reset_counts()
        t0 = time.perf_counter()
        loss = vip_loss(model, x, m)
        loss.backward()
        torch.cuda.synchronize()
        dt = time.perf_counter() - t0
        norm = float(torch.sqrt(sum(p.grad.float().square().sum()
                                    for p in model.parameters()
                                    if p.grad is not None)))
        out[name] = (float(loss), norm, favor_stats.launches,
                     favor_apply.launches)
        print(f"[parallel] ViP {name} (pipe:1, 2 microbatches of 16): "
              f"loss {float(loss):.6f}, gradient norm {norm:.4f}, "
              f"favor_stats launches {favor_stats.launches}, favor_apply "
              f"{favor_apply.launches}, {dt * 1e3:.1f} ms")
    (la, na, _, _), (lb, nb, st, ap) = out["sequence"], out["pipeline"]
    assert st == ap == 3 * 2, (st, ap)
    assert abs(lb - la) <= BF16_REL * abs(la) and \
        abs(nb - na) <= BF16_REL * na, out
    STATS.result["launches"] += st
    APPLY.result["launches"] += ap
    torch.optim.Adam(model.parameters(), lr=5e-4).step()


def phase_parallel(rng):
    """parallel/ on one card: an NCCL group of one process.  The flagship
    at full width (bs 96, bf16) under data:1 (DDP and BatchNorm over the
    group), --param_sharding fsdp and model:1 (the Megatron split), 3
    steps each against the plain trainer's steps on the same weights and
    batches; ViP through pipeline_apply at pipe:1; the Evaluator and a
    mesh= predictor at data:1 against the same without a mesh."""
    import torch.distributed as dist
    from scat_tpu_torch.parallel import mesh as mesh_lib
    card = card_line()
    opt = dataclasses.replace(
        TRAIN, epoch=1, steps_per_epoch=3,
        checkpoint_folder=os.path.join("build", "chip_smoke_parallel"))
    plain = Trainer(opt, image_size=IMAGE)
    assert plain.mesh is None
    batches = list(plain.train_loader)
    want = train_losses(plain, batches)
    step_profile("parallel plain trainer", plain, lambda: batches[0])
    # FSDP2 shards contiguous parameters: its reference holds the
    # convolution weights in NCHW storage too (cuDNN's bf16 algorithms
    # differ by layout, by 3.8% of the first step's gradient norm on an
    # H100 80GB HBM3 at 700 W)
    plain = Trainer(opt, image_size=IMAGE)
    with torch.no_grad():
        for p in plain.state.model.parameters():
            p.data = p.data.contiguous()
    want_nchw = train_losses(plain, batches)
    del plain
    ev_opt = dataclasses.replace(
        opt, steps_per_epoch=2,
        result_dir=os.path.join("build", "chip_smoke_parallel_eval"))
    ev_want = Evaluator(ev_opt, image_size=IMAGE).eval()
    crops = rng.randint(0, 256, (70, IMAGE, IMAGE, 3)).astype(np.uint8)
    live = HandPosePredictor.from_checkpoint(FLAGSHIP, image_size=IMAGE)
    pred_want = live.predict(crops)
    del live
    torch.cuda.empty_cache()

    dist.init_process_group("nccl", init_method=f"tcp://127.0.0.1:"
                            f"{free_port()}", rank=0, world_size=1)
    try:
        for tag, kw, ref in (
                ("data:1 (DDP)", dict(mesh_shape="data:1"), want),
                ("data:1 --param_sharding fsdp (NCHW weights on both "
                 "sides)", dict(mesh_shape="data:1", param_sharding="fsdp"),
                 want_nchw),
                ("data:1,model:1 (Megatron)",
                 dict(mesh_shape="data:1,model:1"), want)):
            mesh_steps(tag, dataclasses.replace(opt, **kw), batches, ref)
            torch.cuda.empty_cache()
        vip_pipeline_step(rng, mesh_lib.make_mesh((("pipe", 1),)))
        torch.cuda.empty_cache()
        reset_counts()
        ev = Evaluator(dataclasses.replace(ev_opt, mesh_shape="data:1"),
                       image_size=IMAGE)
        assert ev.mesh is not None
        got = ev.eval()
        fwd = flash_attention.launches
        print(f"[parallel] Evaluator at data:1: MPJPE {got['mpjpe_mm']:.4f} "
              f"mm, AUC {got['auc']:.5f} (without a mesh "
              f"{ev_want['mpjpe_mm']:.4f}, {ev_want['auc']:.5f}); "
              f"attention_fwd launches {fwd}")
        assert fwd == 3 * 2, fwd
        FWD.result["launches"] += fwd
        assert got["mpjpe_mm"] == ev_want["mpjpe_mm"] and \
            np.array_equal(got["pck"], ev_want["pck"]), (got, ev_want)
    finally:
        mesh_lib.release_mesh()
        dist.destroy_process_group()
    mesh = mesh_lib.make_mesh((("data", 1),), devices=["cuda"])
    pred = HandPosePredictor.from_checkpoint(FLAGSHIP, image_size=IMAGE,
                                             mesh=mesh)
    reset_counts()
    got = pred.predict(crops)
    fwd = flash_attention.launches
    gap = max(float(np.abs(got[k] - pred_want[k]).max()) for k in got)
    print(f"[parallel] mesh= predictor at data:1, 70 crops: largest "
          f"difference from the predictor without a mesh {gap}; "
          f"attention_fwd launches {fwd} ({card})")
    assert gap == 0.0 and fwd == 3 * n_chunks(70, pred._buckets[-1]), fwd
    FWD.result["launches"] += fwd


def capture_stdout(fn, *args):
    """(fn(*args), what it printed), the output echoed."""
    import io
    buf = io.StringIO()
    with contextlib.redirect_stdout(buf):
        out = fn(*args)
    print(buf.getvalue(), end="")
    return out, buf.getvalue()


def phase_files(rng):
    """The file tools on the card: validate_data --n 4 on written trees,
    convert's round trips, a partial .pth served with the JAX package's
    warning, and the export phase's artifact: one weights file, its
    size and load time, and no difference from live serving."""
    from scat_tpu_torch import convert, validate_data
    from scat_tpu_torch.utils import weights
    card = card_line()
    os.makedirs("build", exist_ok=True)
    with tempfile.TemporaryDirectory(prefix="files_", dir="build") as root:
        write_stb_tree(os.path.join(root, "STB"), rng, frames=8)
        for writer in (write_frei_tree, write_ho3d_tree, write_mhp_tree,
                       write_rhd_tree):
            writer(root, rng, n=8)
        for sub in ("STB", "FreiHAND", "HO3D", "MHP"):
            t0 = time.perf_counter()
            rc, text = capture_stdout(validate_data.main, [
                "--data_dir", os.path.join(root, sub), "--n", "4", "--out",
                os.path.join(root, "crops")])
            print(f"[files] validate_data {sub} --n 4 on the card: rc {rc} "
                  f"in {time.perf_counter() - t0:.1f} s")
            assert rc == 0 and "wrote 4 debug crops" in text, text
        report = validate_data.validate_rhd(os.path.join(root, "RHD"))
        print(f"[files] validate_data RHD: {report.codes()} (the written "
              "tree's K is the identity, its uv_vis drawn apart)")
        assert report.codes("error") == ["rhd-projection"], report.codes()

    path = os.path.join(TRAIN.checkpoint_folder, checkpoint.FINAL_NAME)
    bare = os.path.join("build", "chip_smoke_files", "bare.pth")
    t0 = time.perf_counter()
    n = convert.to_pth(dataclasses.replace(TRAIN, checkpoint_path_eval=path),
                       bare)
    trained = torch.load(path, map_location="cpu",
                         weights_only=True)["state_dict"]
    sd = torch.load(bare, weights_only=True)
    assert n == len(sd) == len(trained) and all(
        torch.equal(sd[k], trained[k]) for k in trained)
    trees = weights.flax_from_state_dict("reg_transformer", sd)
    back = weights.state_dict_from_flax(trees["params"], trees["batch_stats"])
    assert all(torch.equal(back[k], sd[k]) for k in sd
               if not k.endswith("num_batches_tracked")), "flax round trip"
    print(f"[files] convert --direction to_pth of {path}: {n} tensors, "
          "equal to the trained ones; flax_from_state_dict and back: "
          f"equal ({time.perf_counter() - t0:.1f} s)")

    donor, _ = build_model(dataclasses.replace(FLAGSHIP, vit_heads=4), IMAGE)
    checkpoint.init_weights(donor, seed=4)
    partial = os.path.join("build", "chip_smoke_files", "heads4.pth")
    torch.save(donor.state_dict(), partial)
    pred, text = capture_stdout(
        HandPosePredictor.from_checkpoint,
        dataclasses.replace(FLAGSHIP, checkpoint_path_eval=partial), IMAGE)
    assert "WARNING: only " in text, text
    crops = rng.randint(0, 256, (7, IMAGE, IMAGE, 3)).astype(np.uint8)
    reset_counts()
    out = pred.predict(crops)
    check_output(out, 7)
    assert flash_attention.launches == 3, flash_attention.launches
    FWD.result["launches"] += flash_attention.launches
    print("[files] the partial .pth (a --vit_heads 4 file) served on the "
          "card: finite outputs, 3 attention_fwd launches")
    bad = os.path.join("build", "chip_smoke_files", "resnet.pth")
    torch.save({k[len("main_encoder."):]: v for k, v in
                donor.state_dict().items() if k.startswith("main_encoder.")},
               bad)
    try:
        HandPosePredictor.from_checkpoint(
            dataclasses.replace(FLAGSHIP, checkpoint_path_eval=bad), IMAGE)
        raise AssertionError("a bare ResNet file loaded into the flagship")
    except ValueError as e:
        assert "architecture mismatch" in str(e), e
    print("[files] a bare torchvision ResNet .pth raises the architecture "
          "mismatch, as the JAX package's loader does")
    del pred, donor

    path = os.path.join(EXPORT_ROOT, "flagship")
    files = {f: os.path.getsize(os.path.join(path, f))
             for f in sorted(os.listdir(path))}
    assert [f for f in files if not f.endswith(".pt2")] == [
        "manifest.json", "weights.npz"], files
    t0 = time.perf_counter()
    art = ExportedPredictor(path)
    load_s = time.perf_counter() - t0
    live = HandPosePredictor.from_checkpoint(FLAGSHIP, image_size=IMAGE)
    gaps = []
    for n_crops in (7, 64):
        x = rng.randint(0, 256, (n_crops, IMAGE, IMAGE, 3)).astype(np.uint8)
        got, want = art.predict(x), live.predict(x)
        gaps += [float(np.abs(got[k] - want[k]).max()) for k in want]
    print(f"[files] the flagship artifact: {sum(files.values()) / 1e6:.1f} "
          f"MB, weights.npz {files['weights.npz'] / 1e6:.1f} MB, loaded in "
          f"{load_s:.2f} s; largest difference from live serving on 7 and "
          f"64 crops {max(gaps)} ({card})")
    assert max(gaps) == 0.0, gaps


def load_example(name):
    """``examples/{name}.py`` as a module (``examples/`` is not a
    package)."""
    spec = importlib.util.spec_from_file_location(
        f"example_{name}", os.path.join(REPO_ROOT, "examples", f"{name}.py"))
    module = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(module)
    return module


def timed(fn, seconds):
    """``fn`` that appends each call's seconds, the card synchronised on
    both sides, to ``seconds``."""
    def call(*args, **kwargs):
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        out = fn(*args, **kwargs)
        torch.cuda.synchronize()
        seconds.append(time.perf_counter() - t0)
        return out
    return call


@contextlib.contextmanager
def example_run(root):
    """Run an example as a user would: in ``root`` as its cwd and temporary
    directory, with PyTorch's default TF32 settings (TF32 convolutions,
    float32 products)."""
    cwd, tmp = os.getcwd(), tempfile.tempdir
    tf32 = (torch.backends.cuda.matmul.allow_tf32,
            torch.backends.cudnn.allow_tf32)
    os.chdir(root)
    tempfile.tempdir = root
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = True
    try:
        yield
    finally:
        os.chdir(cwd)
        tempfile.tempdir = tmp
        (torch.backends.cuda.matmul.allow_tf32,
         torch.backends.cudnn.allow_tf32) = tf32


def example_quickstart(card):
    """examples/quickstart_torch.py at 224 px: 24 train steps, 3 + 3
    attention launches each; the Evaluator's 3 launches a held-out batch
    (the reload evaluates on the plain attention path: none); the
    example's own reload assertion."""
    module = load_example("quickstart_torch")
    make, step_s = steps.make_train_step, []

    def make_train_step(*args, **kwargs):
        return timed(make(*args, **kwargs), step_s)

    reset_counts()
    t0 = time.perf_counter()
    with patched(steps, "make_train_step", make_train_step):
        out = module.main()
    dt = time.perf_counter() - t0
    fwd, bwd = flash_attention.launches, attention_bwd.launches
    n_eval = len(out["held_out"])
    res, res2 = out["eval"], out["reload"]
    gap = abs(res2["mpjpe_mm"] - res["mpjpe_mm"])
    print(f"[examples] quickstart_torch on the card at 224 px, float32: "
          f"{dt:.1f} s; {len(step_s)} train steps at bs 8, p50 step "
          f"{np.median(step_s[1:]) * 1e3:.3f} ms (first "
          f"{step_s[0] * 1e3:.1f} ms); attention_fwd x{fwd}, attention_bwd "
          f"x{bwd} ({len(step_s)} steps x 3 + {n_eval} eval forwards x 3); "
          f"PA-MPJPE {res['mpjpe_mm']!r} mm (kernel path), reloaded .pth "
          f"{res2['mpjpe_mm']!r} mm (plain path), gap {gap!r} (bound 1e-3); "
          f"AUC {res['auc']!r} and {res2['auc']!r} ({card})")
    assert len(step_s) == 24 and all(np.isfinite(list(out["losses"].values())))
    assert (fwd, bwd) == (3 * len(step_s) + 3 * n_eval, 3 * len(step_s)), \
        (fwd, bwd)
    assert gap < 1e-3 and np.isfinite(res["auc"]), (res, res2)
    FWD.result["launches"] += fwd
    BWD.result["launches"] += bwd


def example_serve_artifact(card):
    """examples/serve_artifact_torch.py with no argument: the full-width
    flagship (bf16) exported and served; its request captures one CUDA
    graph (3 attention_fwd launches in the capture and 3 in its eager
    warm-up run), a replay launches none and returns the same outputs,
    and the runner's tally adds 3 for it; the artifact within 2% of the
    live predictor on the same crops."""
    from scat_tpu_torch import export as export_lib
    module = load_example("serve_artifact_torch")
    export_s, load_s, request_s = [], [], []
    reset_counts()
    with patched(export_lib, "export_predictor",
                 timed(export_lib.export_predictor, export_s)), \
            patched(export_lib, "load_artifact",
                    timed(export_lib.load_artifact, load_s)), \
            patched(ExportedPredictor, "predict",
                    timed(ExportedPredictor.predict, request_s)):
        out = module.main()
    served, live, crops = out["served"], out["live"], out["crops"]
    graphs = sum(len(r.keys) for r in served._forwards.values())
    captured = flash_attention.launches
    assert graphs == 1 and captured == 2 * 3 * graphs, (graphs, captured)
    assert served.image_size == IMAGE and served.manifest["device"] == "cuda"
    FWD.result["launches"] += captured
    reset_counts()
    before = replayed(served)["attention_fwd"]
    again = served.predict(crops)
    tally = replayed(served)["attention_fwd"] - before
    assert flash_attention.launches == 0 and tally == 3, \
        (flash_attention.launches, tally)
    for k in again:
        np.testing.assert_array_equal(again[k], out["out"][k], err_msg=k)
    replay_s = []
    for _ in range(20):
        t0 = time.perf_counter()
        served.predict(crops)
        replay_s.append(time.perf_counter() - t0)
    print(f"[examples] serve_artifact_torch (the fresh-init flagship, "
          f"resnet50, 224 px, bf16): export_predictor {export_s[0]:.1f} s, "
          f"load_artifact {load_s[0]:.1f} s, the 5-crop request "
          f"{request_s[0] * 1e3:.1f} ms with its capture; {graphs} graph, "
          f"attention_fwd x{captured} in the capture and its warm-up, x0 on "
          f"a replay, x{tally} in the runner's replay tally; replayed "
          f"request p50 "
          f"{np.median(replay_s) * 1e3:.3f} ms (20 requests, host clock) "
          f"({card})")
    check_output(out["out"], len(crops), root_centred=False)
    want = live.predict(crops)
    compare("examples", [(f"serve_artifact_torch vs live, 5 uint8 crops, "
                          f"{k}", out["out"][k], want[k], None)
                         for k in want])
    shutil.rmtree(out["artifact"])


def example_check_dataset(root, rng, card):
    """examples/check_dataset_torch.py on an STB tree of 8 frames a
    sequence: the synthetic and STB batches on the card, FreiHAND and
    HO-3D skipped (no tree beside it), the plot or matplotlib's skip
    line."""
    module = load_example("check_dataset_torch")
    tree = os.path.join(root, "STB")
    write_stb_tree(tree, rng, frames=8)
    t0 = time.perf_counter()
    seen, text = capture_stdout(module.main, [
        "--data_dir", tree, "--n", "2", "--out_dir", root])
    print(f"[examples] check_dataset_torch on the card: "
          f"{time.perf_counter() - t0:.1f} s ({card})")
    assert [len(seen[k] or ()) for k in seen] == [2, 2, 0, 0], seen
    assert "== FreiHAND: no data, skipped" in text
    assert "== HO3D: no data, skipped" in text
    for name in ("synthetic", "STB"):
        assert all("image(4, 224, 224, 3)" in line and "valid=1.00" in line
                   for line in seen[name]), seen[name]
        assert os.path.exists(os.path.join(root, f"{name}_debug.png")) or \
            "matplotlib unavailable, skipping the dataset debug plot" in text


def phase_examples(rng):
    """The port's three example scripts on the card, in-process, in a cwd
    under build/: the quickstart at 224 px, serve_artifact with no
    argument, check_dataset on a written STB tree."""
    card = card_line()
    os.makedirs("build", exist_ok=True)
    with tempfile.TemporaryDirectory(prefix="examples_", dir="build") as tmp:
        root = os.path.abspath(tmp)
        with example_run(root):
            example_quickstart(card)
            example_serve_artifact(card)
            example_check_dataset(root, rng, card)


# a phase's inputs come from the phase named here, which a partial run
# adds
NEEDS = {"profile": ("slice",), "serve": ("slice",), "stb": ("train",),
         "group-norm": ("train",), "vip-eval": ("vip-train",),
         "files": ("train", "export")}


def main(argv):
    if not torch.cuda.is_available():
        sys.exit("chip_smoke.py: no CUDA device; the port's smoke run "
                 "needs one")
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    t_start = time.perf_counter()
    rng = np.random.RandomState(0)
    state = {}
    phases = [
        ("build", phase_build),
        ("kernels", phase_kernels),
        ("link", phase_link),
        ("slice", lambda: state.update(served=phase_slice(rng))),
        ("profile", lambda: phase_profile(state["served"][0], rng)),
        ("serve", lambda: phase_serve(*state.pop("served"))),
        ("export", lambda: phase_export(rng)),
        ("train", lambda: state.update(synth=phase_train(rng))),
        ("stb", lambda: phase_stb(rng, state["synth"])),
        ("datasets", lambda: phase_datasets(rng)),
        ("group-norm", lambda: phase_group_norm(rng, state["synth"])),
        ("coarse", lambda: phase_coarse(rng)),
        ("token-heads", lambda: phase_token_heads(rng)),
        ("vit", lambda: phase_vit(rng)),
        ("mano", lambda: phase_mano(rng)),
        ("video", lambda: phase_video(rng)),
        ("favor", phase_favor_kernels),
        ("vip-serve", lambda: phase_vip_serve(rng)),
        ("vip-train", lambda: state.update(vip=phase_vip_train(rng))),
        ("vip-eval", lambda: phase_vip_eval(*state["vip"])),
        ("parallel", lambda: phase_parallel(rng)),
        ("files", lambda: phase_files(rng)),
        ("examples", lambda: phase_examples(rng))]
    names = [name for name, _ in phases]
    chosen = set(argv) or set(names)
    unknown = chosen - set(names)
    if unknown:
        sys.exit(f"chip_smoke.py: unknown phase(s) {sorted(unknown)}; the "
                 f"phases are {', '.join(names)}")
    chosen |= {"build"} | {need for n in chosen for need in NEEDS.get(n, ())}
    for k in KERNELS:
        k.result["launches"] = 0
    for name, fn in phases:
        if name not in chosen:
            continue
        torch.cuda.empty_cache()
        t0 = time.perf_counter()
        fused_link.launches = 0
        fn()
        # no model path launches the fused link, as in JAX
        assert name == "link" or fused_link.launches == 0, \
            (name, fused_link.launches)
        print(f"[{name}] done in {time.perf_counter() - t0:.1f} s")
    print(f"[total] {time.perf_counter() - t_start:.1f} s")

    print(card_line())
    if chosen != set(names):
        # a partial run measures part of the kernels' keys: no result
        print(f"[partial run of {', '.join(n for n in names if n in chosen)}]")
        return
    print(json.dumps({"kernels": [
        {"name": k.name, "route": k.route, "source": k.source,
         "replaces": k.replaces, **{key: k.result[key] for key in (
             "launches", "max_abs_err", "ms", "plain_ms", "bound_ms",
             "bound_by", "library_ms")},
         # the forward at the 128-token heads' shape (its persistent kernel)
         **{key: k.result[key] for key in (
             "ms_n128", "bound_ms_n128", "library_ms_n128")
            if key in k.result}}
        for k in KERNELS]}))
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": torch.cuda.get_device_name(0),
        "count": torch.cuda.device_count()}}))


if __name__ == "__main__":
    main(sys.argv[1:])
