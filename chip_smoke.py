#!/usr/bin/env python3
"""Smoke test of the PyTorch/CUDA port (`egovlpv2_torch`) on one NVIDIA GPU.

Run from the root of a checkout on a machine with one card:

    python3 chip_smoke.py

Phases, each printing its own lines; any failure raises and exits non-zero:
  1. device   — CUDA present; the card's name and power limit (nvidia-smi);
                TF32 off for matmul and cuDNN.
  2. build    — nvcc builds the seven sources of csrc/ into
                build/egovlpv2_torch/, one compiler a source, side by side.
  3. kernels  — each kernel against its plain PyTorch version on the card,
                bf16 and f32, with its time, the plain version's, one
                library call's (`library_ms`) and its bound. Every time is
                device time from torch.profiler: all the kernels and copies
                of 20 calls after 3 warm, over 20 (a CUDA-event window
                would also take in the card's waits for the host).
                Attention, H=12, Dh=64:
                forward K1 space, K2 time, K3 CLS row at B=20, S=785 and
                S=3137 (the EgoMCQ shapes), B=16, S=785 (the pretrain
                step's), B=8, S=6273 (the 32-frame fine-tune's), B=64,
                S=3137 (an MQ or NLQ inner batch), B=16, S=981 (a QFVS
                inner batch: 5 frames) and B=8, S=785 (the EgoTaskQA
                step's, where f32 takes K10/K11), against the plain version on the
                same values raised to f32 (in bf16 the plain version rounds
                P, and two bf16 results one step apart at a value of 4 or
                more differ by 3.1e-2 already; it is timed in bf16); max abs
                error <= 2e-2 in bf16 and <= 1e-4 in f32 (another summation
                order); K3's lse0 within 1e-5 of max |reference| of row 0
                of `row_lse_reference`, and K3 twice on one input gives the
                same bits (its runs of keys merge in a fixed order);
                backward K4 space, K5 time, K6 CLS row at B=16, S=785 and
                S=3137, B=8, S=6273 and B=8, S=785 against autograd through the plain
                version; max abs
                error of each of dq, dk, dv <= 2e-2 (bf16) / 1e-4 (f32) of
                max |reference| of that tensor, the CLS row and the patch
                rows each by its own maximum (a gradient's scale follows
                the cotangent's, and the CLS key's dk/dv are many times a
                patch key's; the kernels keep P, dP, delta and dS in f32
                and round P and dS to bf16 at most as the operands of the
                products that take them, the plain version's autograd in
                bf16 rounds P, dP and dS; K6 rounds the dk/dv rows a second time when it adds
                to them); K6 is fed K3's output and lse0, as the autograd
                Function runs it, twice on one input gives the same bits,
                and is timed adding to the rows K4/K5 wrote. K5 twice on one
                input gives the same bits in dqkv and in its CLS-key
                partials (a fixed-order sum in a block), and its profiled
                kernels are those of the form `time_bwd_geometry` names
                (the tensor cores in bf16 at these shapes: one
                `time_bwd_kernel`; f32 the grouped query and key passes).
                K2 twice on one input gives the same bits, and its profiled
                kernel is the one of the form `time_fwd_geometry` names
                (`time_fwd_tc_kernel`, the tensor cores, or the grouped
                `time_fwd_kernel`).
                K1 and K4 likewise: twice the same bits, the profiled
                kernels those of the form `space_fwd_geometry` /
                `space_bwd_geometry` names (in bf16 the frame forms, one
                `space_fwd_frame_kernel` / `space_bwd_frame_kernel` launch,
                K4's `cls_part` one row a frame), and K6 after K4, fed its
                `cls_part`, against the whole space-axis gradient. K4's
                frame form is also held to the plain version of its frame
                block (`space_frame_grad_reference`), which rounds as the
                TPU kernel does: P, dP, delta and dS in f32, P rounded to
                bf16 only before dV and dS only before dQ and dK; dq, dk,
                dv of the patch rows and each frame's CLS-key dk, dv within
                2e-2 of max |reference| of each.
                K1's, K2's, K3's, K4's, K5's and K6's times before their
                redesigns (K1_BEFORE_MS ... K6_BEFORE_MS) are printed beside
                the new ones on the text line only.
                LayerNorm K7 forward and K8 backward at R x D = 12,560 x
                768 (the pretrain step's), 50,184 x 768 (the fine-tune's),
                200,768 x 768 (an MQ or NLQ inner batch), 15,696 x 768 (a
                QFVS one), 240 x 768 (text rows), 301 x 776, 120 x 768
                and 6,280 x 768 (the f32 EgoTaskQA step's text and video
                rows) and 62,740 x 768 (EgoMCQ 16f's video rows), eps 1e-5
                and 1e-12, and in f32 at eps 1e-6 (flax's)
                at the downstream heads' 8,192 x 128 and 480 x 128 (VSLNet's
                video and query rows at batch 32) and 4,000 x 768 (the QFVS
                scorer's 20 x 200 shots), whose times go into the JSON line
                under "heads",
                against `layernorm_reference` and
                `layernorm_backward_reference`: y and dx within 2e-2 (bf16:
                one rounding step where the f32 values differ in their last
                bits) / 1e-5 (f32: a row's sums in another order) of max
                |reference|, dscale and dbias within 1e-3 of max
                |reference| (f32 sums over the rows in another order); the
                times are taken over input sets that together exceed the
                L2 cache. Library: `F.layer_norm` and its autograd backward.
                K7 and K8 each twice on one input give the same bits, and
                their profiled kernels are K7's one launch (a block a
                group of rows, at `layernorm_fwd_geometry`'s pieces a
                thread) and K8's two (the pass over the rows, the sum of
                the blocks' partials).
                Beside K7's device time: a CUDA-event window's time and the
                host's a call of its wrapper, and its time before scale
                and bias were loaded with the row (K7_BEFORE_MS).
                Fused attention K9, H=12, Dh=64, against
                `flash_attention_reference` on strided views as the models
                hand them over (q a transposed view of a [B, S, H*Dh]
                projection; k and v slices of one packed projection in i2t):
                text self-attention at B=64, L=15, B=8, L=30 and (QFVS) B=16
                and B=3, L=15; i2t and t2i at B=16, S=785, at B=20, S=3137,
                at B=64, S=3137 (NLQ) and at B=16, S=981 (QFVS), L=15,
                and i2t at B=8, S=785 (the f32 EgoTaskQA step's);
                B=16 at Sq=Sk=197 and Sq=Sk=64; with a padding mask where the
                models have one, one batch row fully masked; two odd
                cases (Dh=40 and Dh=12, Sq=37, Sk=33: the 3xTF32 forms in
                bf16 too, Dh=12 element by element); t2i at B=4,
                S=3137 with a padding mask, batch row 0 fully masked and
                batch row 1's second run of keys too (a split that must
                weigh 0 in the merge), t2i at B=5, S=3137 (EgoMCQ, one
                question: three splits and a merge), and last the f32
                EgoTaskQA evaluation's t2i at B=8, S=785 and text
                self-attention at B=8, L=15 (f32 splits the t2i keys into
                four runs there); every call prints the form
                `flash_fwd_geometry` names (the few-query calls with their
                run and splits, the bf16 i2t's ring form with its rows a
                block, splits and ring, and its time before the ring form,
                K9_I2T_BEFORE_MS), the profiled kernels of a call must be
                the ones it names (the split kernel, and the merge where
                there is more than one split), and two calls on one input
                must give the same bits; max abs
                error of max |reference| <= 4e-3 in bf16 against the
                reference on the same values in f32, not rounded (the
                kernel keeps P in f32 as the reference does, so what is left
                is the one rounding of the output, at most 2^-8 of the
                largest value) / 1e-4 (f32: 3xTF32 products, about f32's
                error, summed in another order); no input copied. The f32
                EgoTaskQA shapes' times also go into the JSON line
                ("f32_taskqa"). Plain: today's
                `attend_plain`. Library: one
                `F.scaled_dot_product_attention` call. Beside K9's device
                time: K9's own kernel time, the device events of a call,
                and a CUDA-event window's time and the host's a call over
                the same calls.
                General divided attention K10 (forward) and K11 (backward)
                at GENERAL_CASES: f32 at the EgoTaskQA shape (B=8, S=785,
                both axes) on the packed qkv and on a permuted view of a
                [3, B, H, S, Dh] tensor; f32 space at 6 frames (S=1177, the
                frame-block regime of TPU rows 3/4); bf16 time at F=12,
                N=64 (S=769, row 1d's regime); Dh=12 in f32 and bf16, H=2;
                against the plain version on the same values in f32, within
                1e-4 (f32) / 2e-2 (bf16) of max |reference|, dq, dk and dv
                with the CLS row and the patch rows each by its own
                maximum; K10's lse within 1e-5 of max |reference| of
                `row_lse_reference`; K11 from K10's output and lse, as the
                autograd Function runs it; K10 and K11 each twice on one
                input, bitwise equal (no atomics); each time printed beside
                its time before the tiled redesign (K10_BEFORE_MS,
                K11_BEFORE_MS) on the text line only. Library:
                `scaled_dot_product_attention` with the dense [S, S]
                additive mask, and its autograd backward.
  4. tiny     — one small model (depth 4, 2 fused, width 128, 2 heads of
                64, 4 frames of 4x4 patches) from one seeded state_dict on
                the card (kernels: f32 takes K10/K11, K1-K6 none) and on
                the CPU (plain), f32: EgoMCQ VTC
                and VTM agree within 1e-3; one training step's loss parts
                within 1e-3 and every parameter's gradient within 1e-3 of
                max |cpu gradient|, from the same batch and mined indices,
                dropout 0; the same for one dual fine-tune step (small
                projection, NormSoftmax), without and with per-block
                rematerialisation; K7-K11 launched, K1-K6 not; the
                EgoTaskQA model at a head dim of 12 (width 24, 2 heads):
                logits, loss and every gradient within 1e-3; then the
                outputs of `FeatureExtractor` (MQ features from uint8 frames,
                NLQ fused features, raw query tokens) and of
                `QFVSExtractor.extract_video` (5 frames a clip) within 1e-3
                of max |cpu output|, the change points (one scene cut in
                the frames) found and equal.
  5. slices   — at full width (TimeSformer-B + RoBERTa-base, 6 fused blocks
                each, ITM and MLM heads, projection 4096), bf16:
                `egovlpv2_torch.cli egomcq` from configs/eval_egomcq.json
                at 16 frames, batch 4 x 5 candidates, then 4 frames, then
                16 frames one question at a time (batch 1 x 5: K9's t2i
                splits its keys and merges): every score finite, the five
                forward kernels launched;
                `egovlpv2_torch.cli pretrain --synthetic`: batch 16, 4
                frames, no remat: every loss part finite at every step,
                parameters changed, all nine kernels launched every step,
                K8's launches a step printed by row count (so in the
                fine-tune and EgoTaskQA runs). Without remat on one card
                the step replays as one CUDA graph from its third step
                (`train/step.py::GraphStep`; the pretrain, the fine-tune
                without remat, the feed, the loop and the bench): a replay
                calls no kernel wrapper, so the launches a step are counted
                over the steps whose wrappers ran (the eager first, the
                capturing second: `_step_kinds`, from the span ring), and
                the hand kernels of the first step and of the last, a
                replay, are taken by `__global__` name from the profiler
                and must be the same, launch for launch (`_witnessed`);
                `egovlpv2_torch.cli ft-charades --synthetic` from
                configs/ft_charades.json (32 frames, S=6273, small
                projection at 256, 30 text tokens), batch 8: 5 steps
                without rematerialisation, then 2 steps of a fresh trainer
                with `model.remat` as the file has it: every loss finite,
                parameters changed, K1-K8 launched every step (its text
                attention drops probabilities in training, so K9 stays out);
                the three extraction paths from configs/extract_mq.json (16
                frames, S=3137): `egovlpv2_torch.cli extract --synthetic
                2048` (MQ: 128 windows in two inner batches of 64, uint8 in,
                [128, 4096] out); `extract_nlq_features` with two queries
                over the same frames (fused [128, 768] and the raw query
                tokens [15, 768]); `QFVSExtractor.extract_video` on 400
                frames at 5 frames a clip (80 clips, S=981, inner batch 16,
                two concepts and one oracle prompt): every output finite and
                of its shape, K1, K2, K3 and K7 launched on all three, K9 on
                the two fused ones, no K9 input copied; none of K10/K11 on
                a bf16 path;
                `run_egotaskqa` (tasks/orchestrators.py) at the
                `TrainConfig` defaults, float32 (4 frames at 224, S=785, 15
                tokens), batch 8, 5 steps on seeded in-memory items over
                100 synthetic answers, then the evaluation over 2 batches:
                every loss finite, K11 24 launches a step and K10 48 (each
                block's forward again in the backward: `model.remat` is on
                in the defaults), K1-K6 none; K9 by form: a step 12
                `many_queries_tf32` (the fused i2t, again under remat) and
                nothing else, the evaluation 6 `many_queries_tf32` and 18
                `few_queries_tf32` (12 text self-attentions, 6 t2i) a
                batch; step ms, clips/s, peak memory. A training step is
                timed from its next() on the batch iterator
                (`cli._train_loop`), so the synthetic batch's host RNG
                counts in it.
  6. feed     — the batch feed of the commands on files, at full width,
                bf16, weights from a seed (`feed_runs`): pretrain b16 4f
                over the port's DataLoader (4 worker threads) on
                `SyntheticVideoTextDataset` (the card's machine has no
                OpenCV for the EgoClip files), and the 32-frame fine-tune
                cycling three numpy batches made once; each through
                `device_prefetch` with the card's put (`DevicePut`) at
                depth 0 (inline) and 2, from the same seed: 2 warm steps, 8
                timed (the wall clock a step printed beside the card's name
                and power limit), 2 under torch.profiler (the batch copies'
                device time, pinned memory and stream, which must run no
                kernel of the step, their time inside the device's busy
                periods, pinned allocations in the window). The losses at the
                two depths agree within FEED_LOSS_RTOL, and each prefetched
                batch equals its synchronous copy bit for bit.
  7. loop     — the training loop of `egovlpv2_torch.cli pretrain`
                (`cli._fit`) at full width, pretrain b16 4f bf16 from the
                seed, in a temporary directory outside the checkout, with a
                synthetic EgoMCQ validation (VTC and VTM, one batch of 4
                questions) after each epoch and `--monitor
                max:vtc/Inter-video`: run C, two epochs of two steps
                without a save; run A, one epoch with `--init_val`, saved
                (config.json, progress.json at epoch 0, monitor.json,
                best_step.json); run B, two epochs with `--resume` from A,
                which logs "resumed from step 2 (epoch 1)" and "restored
                monitor", and whose losses of steps 3-4 and validation
                after epoch 1 (its accuracies and its raw VTC/VTM scores,
                which must be finite) must be run C's bit for bit (the
                first value that differs is printed); then `egomcq --ckpt <A/B's
                ckpt/>`, whose model must hold the best step's parameters
                exactly. The steps launch K1-K9, each validation K1-K3, K7
                and K9 (counted apart: `launches_by_path` "pretrain_val"),
                egomcq the same five. Printed beside the card's name and
                power limit: the checkpoint's bytes, each save's and
                restore's ms, the validation's ms a batch (its eval
                steps alone, and the whole validation with the synthetic
                batch's host draw), the phase's seconds. No file may be left under the checkout or in the
                temporary directory, and no pinned host memory held (PyTorch's
                host allocator holds none once its cache is emptied).
  8. heads    — the downstream heads through their commands at the
                published widths, float32 with TF32 off, on seeded files
                written to a temporary directory outside the checkout in the
                formats the readers take (Ego4D moments jsons, ego4d.json and
                [T, 4096] clip features; NLQ jsons, [W, 768] window features
                and [15, 768] query tokens; QFVS oracle summaries, dense
                per-shot tags, Tags.mat and P0<v>.npz shot features):
                `cli mq-anno` then `cli mq` (VSGN, T=928, 5 levels, 110
                classes + background, batch 16, 2 epochs of 2 steps, 2
                windows inferred; its four output files written; no hand
                kernel launched), `cli nlq` (VSLNet, batch 32, max_pos_len
                256, 2 epochs) and `cli qfvs` (the scorer over 20 x 200
                shots, d_model 768, 2 epochs over 2 videos, 1 held out):
                every metric finite, and K8's launches a training step by
                row count as the models have them (VSLNet 6 at 480 rows and
                20 at 8,192, the scorer 12 at 4,000), K7 launched, no other
                kernel. Printed beside the card's name and power limit: each
                head's step ms and median warm step, peak device memory,
                inference ms a window / query / item, the host's proposal
                and NMS ms a window (MQ), and the phase's seconds. No file
                may be left and no pinned host memory held, as in phase 7.
  9. multiprocess — `egovlpv2_torch.cli pretrain --synthetic --device cuda`
                at phase 5's settings (b16 4f bf16, full width) for
                DIST_STEPS steps under a process group of world size 1 over
                NCCL, started by the port's own flags (`--coordinator
                localhost:<free port> --num_processes 1 --process_id 0`) in
                a child process with a time limit: its step gathers the
                embeddings, the unfused video tokens, the ITM logits and
                the MLM sums, and averages the gradients, over NCCL. The
                first loss (the forward before any update) must equal that
                of the same run without a group and with the eager step
                (in this process) and phase 5's, bit for bit, and the next
                the eager run's within DIST_LOSS_RTOL (the embedding
                backward sums with atomics); K1-K9 launched every step
                ("pretrain_dist" in `launches_by_path`). Printed beside the
                card's name and power limit: each step's largest relative
                difference of the losses from the eager run, with the group
                and in phase 5's replays; the median of steps 3 on with the
                group and, over the same steps, the eager run's without
                it; the device time a step of the
                gradient mean and of the forward gathers (CUDA events
                around each call); the peak of device memory with the group
                and the eager run's without it. Then two ranks asked
                for on the one card: both must exit non-zero with the
                refusal of `parallel/distributed.py` ("two ranks on one
                device") within REFUSE_TIMEOUT seconds.
 10. bench    — `python -m egovlpv2_torch.cli bench --device cuda` in a
                child process with a time limit, at the bench's defaults
                (BENCH_BATCH 16, no remat; full width, bf16): one synthetic
                batch put once, BENCH_WARMUP warm and BENCH_ITERS timed
                steps with two in flight. Its one JSON line must have a
                finite `value` > 0, `devices` 1, `global_batch` 16 and a
                finite `loss`; the steps eager, capturing, then replayed;
                K1-K9 launched a whole number of times a step whose wrappers
                ran (at least once), K10/K11 never ("bench" in
                `launches_by_path`), the hand kernels of the first step and
                of the last warm one (a replay) the same by the profiler;
                the batch it reuses unchanged after
                its last step. Printed beside the card's name and power
                limit: the JSON line, the launches a step, the host
                synchronisations inside one timed step (PyTorch's sync
                debug mode warns at each) and where they come from, the
                host's draw of one such batch and its put (three times
                each, in this process), phase 5's median step (which holds
                both) beside the bench's, the peak memory and the phase's
                seconds.
Then one JSON line of the kernels and, last, the result line.
"""

import argparse
import contextlib
import dataclasses
import gc
import gzip
import io
import itertools
import json
import os
import re
import shutil
import subprocess
import sys
import tempfile
import time
from pathlib import Path

import numpy as np
import scipy.io as scipy_io
import torch
from torch.autograd import DeviceType
from torch.nn import functional as F
from torch.profiler import ProfilerActivity, profile

from egovlpv2_torch import cli
from egovlpv2_torch.bench import bench_config
from egovlpv2_torch.core.config import load_train_config
from egovlpv2_torch.data.datasets import SyntheticVideoTextDataset
from egovlpv2_torch.data.loader import (DataLoader, default_collate,
                                        device_prefetch, device_put)
from egovlpv2_torch.downstream.taskqa import (make_qa_model,
                                              synthetic_qa_items)
from egovlpv2_torch.models.egovlp import EgoVLPv2
from egovlpv2_torch.objectives.itm_mining import ITMIndices
from egovlpv2_torch.objectives.losses import cross_entropy_loss
from egovlpv2_torch.parallel.mp_worker import free_port, run_ranks
from egovlpv2_torch.data.tokenizer import Tokenizer
from egovlpv2_torch.ops import _kernels, flash
from egovlpv2_torch.ops import layernorm as ln
from egovlpv2_torch.ops.attention import attend_plain, make_additive_mask
from egovlpv2_torch.ops.divided import (cls_row_reference,
                                        divided_attention_backward_reference,
                                        divided_attention_reference,
                                        grouped_reference, live_mask,
                                        row_lse_reference,
                                        space_frame_grad_reference)
from egovlpv2_torch.tasks.egomcq import make_egomcq_eval_step
from egovlpv2_torch.tasks.extract import FeatureExtractor, extract_nlq_features
from egovlpv2_torch.tasks.orchestrators import run_egotaskqa
from egovlpv2_torch.tasks import pretrain as pretrain_task
from egovlpv2_torch.tasks import retrieval as retrieval_task
from egovlpv2_torch.tasks.pretrain import build_pretrain, synthetic_batch
from egovlpv2_torch.tasks.qfvs_extract import QFVSExtractor
from egovlpv2_torch.tasks.retrieval import (build_dual, dual_loss_fn,
                                            synthetic_dual_batch)
from egovlpv2_torch.train import step as train_step_module
from egovlpv2_torch.utils.logging import CAPTURE, REPLAY, SPANS, STEP
from egovlpv2_torch.weights import random_init_, training_init_

FWD_SOURCE = "egovlpv2_torch/csrc/divided_attention.cu"
TIME_FWD_SOURCE = "egovlpv2_torch/csrc/time_attention.cu"  # K2's tensor cores
SPACE_SOURCE = "egovlpv2_torch/csrc/space_attention.cu"  # K1's and K4's frames
BWD_SOURCE = "egovlpv2_torch/csrc/divided_attention_bwd.cu"
LN_SOURCE = "egovlpv2_torch/csrc/layernorm.cu"
FLASH_SOURCE = "egovlpv2_torch/csrc/fused_attention.cu"
GENERAL_SOURCE = "egovlpv2_torch/csrc/divided_attention_general.cu"
KERNELS = {  # name -> (source, the TPU kernel body it replaces)
    # K1's and K4's frame forms, which every bf16 path runs (their grouped
    # forms, for f32, are in FWD_SOURCE and BWD_SOURCE)
    "space_attention_fwd": (SPACE_SOURCE, "egovlpv2_tpu/ops/divided.py:774"),
    # K2's tensor-core form, which every bf16 path runs (its grouped form,
    # for f32, is in FWD_SOURCE)
    "time_attention_fwd": (TIME_FWD_SOURCE, "egovlpv2_tpu/ops/divided.py:811"),
    "cls_row_attention_fwd": (FWD_SOURCE, "egovlpv2_tpu/ops/divided.py:359"),
    "space_attention_bwd": (SPACE_SOURCE, "egovlpv2_tpu/ops/divided.py:623"),
    "time_attention_bwd": (BWD_SOURCE, "egovlpv2_tpu/ops/divided.py:957"),
    "cls_row_attention_bwd": (BWD_SOURCE, "egovlpv2_tpu/ops/divided.py:377"),
    "layernorm_fwd": (LN_SOURCE, "egovlpv2_tpu/ops/layernorm.py:52"),
    "layernorm_bwd": (LN_SOURCE, "egovlpv2_tpu/ops/layernorm.py:65"),
    "fused_attention_fwd": (FLASH_SOURCE, "egovlpv2_tpu/ops/flash.py:37"),
    "divided_attention_general_fwd": (GENERAL_SOURCE,
                                      "egovlpv2_tpu/ops/divided.py:544"),
    "divided_attention_general_bwd": (GENERAL_SOURCE,
                                      "egovlpv2_tpu/ops/divided.py:565"),
}
# K10/K11 replace row 1d too: the dense masked branch of the packed kernels;
# K5 the patch-major window branch of the packed backward at F > 8, K2 that
# of the packed forward.
ALSO_REPLACES = {
    "divided_attention_general_fwd": ["egovlpv2_tpu/ops/divided.py:855"],
    "divided_attention_general_bwd": ["egovlpv2_tpu/ops/divided.py:915"],
    "time_attention_bwd": ["egovlpv2_tpu/ops/divided.py:874"],
    "time_attention_fwd": ["egovlpv2_tpu/ops/divided.py:789"],
}
GROUPED_KERNELS = tuple(KERNELS)[:6]  # K1-K6: bf16, contiguous, Dh % 8 == 0
GENERAL_KERNELS = ("divided_attention_general_fwd",
                   "divided_attention_general_bwd")  # K10/K11: the rest
# the kernels of the bf16 paths (pretrain, EgoMCQ, extraction): K1-K9
BF16_PATH_KERNELS = tuple(k for k in KERNELS if k not in GENERAL_KERNELS)
# the path whose run gives a kernel's `launches` in the JSON line
MAIN_PATH = {k: "taskqa" if k in GENERAL_KERNELS else "pretrain"
             for k in KERNELS}
TOL = {torch.bfloat16: 2e-2, torch.float32: 1e-4}  # forward abs, backward rel
H, DH, N = 12, 64, 196  # ViT-B heads, 14x14 patches
# (B, frames); (8, 4) is the EgoTaskQA step's shape, where f32 takes K10/K11:
# K1-K6's f32 forms are timed there beside them
FWD_CASES = ((20, 4), (20, 16), (16, 4), (8, 32), (64, 16), (16, 5), (8, 4))
BWD_CASES = ((16, 4), (16, 16), (8, 32), (8, 4))
MAIN_CASE = (torch.bfloat16, 16, 4)  # the pretrain step's: the JSON line's times
# LayerNorm: (rows, D); y and dx, then dscale and dbias, of max |reference|
LN_CASES = ((16 * 785, 768), (8 * 6273, 768), (64 * 3137, 768),
            (16 * 981, 768), (240, 768), (301, 776),
            # the f32 EgoTaskQA step's text and video rows
            (120, 768), (8 * 785, 768),
            # EgoMCQ 16f's video rows (20 clips)
            (20 * 3137, 768))
LN_MAIN_CASE = (torch.bfloat16, 16 * 785, 768)
LN_TOL = {torch.bfloat16: 2e-2, torch.float32: 1e-5}
LN_SUM_TOL = 1e-3
LN_EPS = (1e-5, 1e-12)
# The downstream heads' LayerNorms, f32 at flax's eps 1e-6: VSLNet's video
# rows (32 x 256) and query rows (32 x 15) at D = 128, the QFVS scorer's
# rows (20 segments x 200 shots) at D = 768; their times go into the JSON
# line too, under "heads"
HEAD_LN_CASES = ((32 * 256, 128), (32 * 15, 128), (20 * 200, 768))
HEAD_LN_EPS = (1e-6,)
LN_RUNS = (((torch.bfloat16, torch.float32), LN_CASES, LN_EPS),
           ((torch.float32,), HEAD_LN_CASES, HEAD_LN_EPS))
# Fused attention: (label, B, H, Sq, Sk, Dh, layout, masked). Layout "packed":
# k and v are slices of one [B, Sk, 2, H, Dh] projection (i2t); "heads": each
# of q, k, v is a transposed view of its own [B, S, H*Dh] projection. Masked
# "split": batch row 1's second run of keys of `flash_fwd_geometry` masked
# too.
FLASH_CASES = (
    ("text self", 64, H, 15, 15, DH, "heads", True),
    ("text self", 8, H, 30, 30, DH, "heads", True),
    ("text self", 16, H, 15, 15, DH, "heads", True),
    ("text self", 3, H, 15, 15, DH, "heads", True),
    ("i2t", 16, H, 785, 15, DH, "packed", True),
    ("i2t", 20, H, 3137, 15, DH, "packed", True),
    ("i2t", 64, H, 3137, 15, DH, "packed", True),
    ("i2t", 16, H, 981, 15, DH, "packed", True),
    ("t2i", 16, H, 15, 785, DH, "heads", False),
    ("t2i", 20, H, 15, 3137, DH, "heads", False),
    ("t2i", 64, H, 15, 3137, DH, "heads", False),
    ("t2i", 16, H, 15, 981, DH, "heads", False),
    ("above 32", 16, H, 197, 197, DH, "heads", False),
    ("above 32", 16, H, 64, 64, DH, "heads", True),
    ("odd", 3, 5, 37, 33, 40, "heads", True),
    ("odd", 3, 2, 37, 33, 12, "heads", True),
    # last, so the cases above keep their seeded inputs
    ("i2t", 8, H, 785, 15, DH, "packed", True),  # EgoTaskQA's, in f32
    # several splits, one of them all masked in batch row 1
    ("t2i masked", 4, H, 15, 3137, DH, "heads", "split"),
    # EgoMCQ 16f, one question (`--batch_size 1`): 60 (b, h), 3 splits
    ("t2i", 5, H, 15, 3137, DH, "heads", False),
    # the f32 EgoTaskQA evaluation's t2i and text self-attention
    ("t2i", 8, H, 15, 785, DH, "heads", False),
    ("text self", 8, H, 15, 15, DH, "heads", True),
)
FLASH_MAIN_CASE = (torch.bfloat16, "i2t", 16, 785)  # the pretrain step's
# the f32 EgoTaskQA step's i2t and its evaluation's t2i and text: their
# times go into the JSON line too, under "f32_taskqa"
FLASH_TASKQA_CASES = ((torch.float32, "i2t", 8, 785, 15),
                      (torch.float32, "t2i", 8, 15, 785),
                      (torch.float32, "text self", 8, 15, 15))
# K9 in bf16 is held to the reference on the same values in f32, unrounded:
# P stays f32 in both, so only the output's one rounding is left (2^-8).
FLASH_TOL = {torch.bfloat16: 4e-3, torch.float32: 1e-4}
# K9's kernels by form, as the profiler names them
FLASH_KERNELS = {"few_queries": ("fused_split_kernel", "fused_merge_kernel"),
                 "many_queries": ("fused_ring_kernel",),
                 "many_queries_chunked": ("fused_fwd_kernel",),
                 "few_queries_tf32": ("fused_tf32_split_kernel",
                                      "fused_merge_kernel"),
                 "many_queries_tf32": ("fused_tf32_fwd_kernel",)}
# General divided attention, K10 and K11: (label, layout, dtype, axis, B, F,
# N, H, Dh). Layout "packed": the [B, S, 3, H, Dh] view of the qkv Linear
# output (row 1d's); "permuted": a permute of a [3, B, H, S, Dh] tensor (rows
# 3 and 4's), read by stride without a copy.
GENERAL_CASES = (
    ("taskqa", "packed", torch.float32, "space", 8, 4, N, H, DH),
    ("taskqa", "packed", torch.float32, "time", 8, 4, N, H, DH),
    ("taskqa", "permuted", torch.float32, "space", 8, 4, N, H, DH),
    ("taskqa", "permuted", torch.float32, "time", 8, 4, N, H, DH),
    ("rows 3/4 frame-block", "packed", torch.float32, "space", 2, 6, N, H, DH),
    ("row 1d", "packed", torch.bfloat16, "time", 16, 12, 64, H, DH),
    ("Dh=12", "packed", torch.float32, "space", 4, 4, N, 2, 12),
    ("Dh=12", "packed", torch.bfloat16, "time", 4, 4, N, 2, 12),
)
GENERAL_MAIN_CASE = ("taskqa", "packed", torch.float32, "space")
# K10's profiler device time a call before its tiled redesign (the one warp
# a row form), ms, at GENERAL_CASES, as PERF.md section 6 records it (H100
# 80GB HBM3, 700 W), printed beside this run's time; keyed by (label,
# layout, dtype, axis).
K10_BEFORE_MS = {
    ("taskqa", "packed", torch.float32, "space"): 4.2556,
    ("taskqa", "packed", torch.float32, "time"): 0.7308,
    ("taskqa", "permuted", torch.float32, "space"): 4.0172,
    ("taskqa", "permuted", torch.float32, "time"): 0.7305,
    ("rows 3/4 frame-block", "packed", torch.float32, "space"): 1.3267,
    ("row 1d", "packed", torch.bfloat16, "time"): 0.9147,
    ("Dh=12", "packed", torch.float32, "space"): 0.4009,
    ("Dh=12", "packed", torch.bfloat16, "time"): 0.3512,
}
# K11's device time a call before its tiled redesign (the one warp a row
# form), ms, the same way: PERF.md section 6 (H100 80GB HBM3, 700 W).
K11_BEFORE_MS = {
    ("taskqa", "packed", torch.float32, "space"): 7.6505,
    ("taskqa", "packed", torch.float32, "time"): 1.2476,
    ("taskqa", "permuted", torch.float32, "space"): 7.6062,
    ("taskqa", "permuted", torch.float32, "time"): 1.2444,
    ("rows 3/4 frame-block", "packed", torch.float32, "space"): 3.9889,
    ("row 1d", "packed", torch.bfloat16, "time"): 1.9689,
    ("Dh=12", "packed", torch.float32, "space"): 1.1407,
    ("Dh=12", "packed", torch.bfloat16, "time"): 0.4735,
}
# K3's and K6's profiler device time a call before their split over key
# runs (one block a (batch, head)), ms, keyed by (dtype, B, frames): the
# parent commit's phase 3 as PERF.md section 6 records it (H100 80GB HBM3,
# 700 W), printed beside this run's time on the text line only.
K3_BEFORE_MS = {
    (torch.bfloat16, 8, 4): 0.0173, (torch.bfloat16, 8, 32): 0.2177,
    (torch.bfloat16, 16, 4): 0.0292, (torch.bfloat16, 16, 5): 0.0391,
    (torch.bfloat16, 20, 4): 0.0340, (torch.bfloat16, 20, 16): 0.1216,
    (torch.bfloat16, 64, 16): 0.3021,
    (torch.float32, 8, 4): 0.0266, (torch.float32, 8, 32): 0.2107,
    (torch.float32, 16, 4): 0.0373, (torch.float32, 16, 5): 0.0445,
    (torch.float32, 20, 4): 0.0418, (torch.float32, 20, 16): 0.1499,
    (torch.float32, 64, 16): 0.4249,
}
K6_BEFORE_MS = {
    (torch.bfloat16, 8, 4): 0.0602, (torch.bfloat16, 8, 32): 0.5445,
    (torch.bfloat16, 16, 4): 0.0910, (torch.bfloat16, 16, 16): 0.3417,
    (torch.float32, 8, 4): 0.0879, (torch.float32, 8, 32): 0.6437,
    (torch.float32, 16, 4): 0.1270, (torch.float32, 16, 16): 0.4806,
}
# K5's the same way before its tensor-core form (the grouped CUDA-core
# passes at every shape): the parent commit's phase 3 (H100 80GB HBM3, 700 W).
K5_BEFORE_MS = {
    (torch.bfloat16, 8, 4): 0.1353, (torch.bfloat16, 8, 32): 3.9671,
    (torch.bfloat16, 16, 4): 0.2205, (torch.bfloat16, 16, 16): 2.1420,
    (torch.float32, 8, 4): 0.1264, (torch.float32, 8, 32): 3.8167,
    (torch.float32, 16, 4): 0.2400, (torch.float32, 16, 16): 2.0750,
}
# K2's the same way before its tensor-core form (the grouped CUDA-core form
# at every shape): PERF.md section 6's table (H100 80GB HBM3, 700 W), bf16.
K2_BEFORE_MS = {
    (torch.bfloat16, 16, 4): 0.0623, (torch.bfloat16, 16, 5): 0.0854,
    (torch.bfloat16, 20, 16): 0.8013, (torch.bfloat16, 64, 16): 2.5361,
    (torch.bfloat16, 8, 32): 1.2022,
}
# K1's and K4's the same way before their frame forms (a block 64 query or
# key rows of a frame, K4 two launches): bf16, the mean of the parent
# commit's two runs of `scripts/profile_torch_kernels.py` in the call that
# compared the trees in turns (H100 80GB HBM3, 700 W), PERF.md section 6.
K1_BEFORE_MS = {
    (torch.bfloat16, 8, 4): 0.0635, (torch.bfloat16, 8, 32): 0.4655,
    (torch.bfloat16, 16, 4): 0.1217, (torch.bfloat16, 16, 5): 0.1515,
    (torch.bfloat16, 20, 4): 0.1467, (torch.bfloat16, 20, 16): 0.5703,
    (torch.bfloat16, 64, 16): 1.8369,
}
K4_BEFORE_MS = {
    (torch.bfloat16, 8, 4): 0.2701, (torch.bfloat16, 8, 32): 2.0068,
    (torch.bfloat16, 16, 4): 0.5219, (torch.bfloat16, 16, 16): 1.9965,
}
# K9's bf16 i2t (over 15 keys) before its ring form (the chunked form, 64
# query rows a block), ms, keyed by (B, Sq), and K7's before scale and bias
# were loaded with the row (after its sums), keyed by (dtype, rows, D): PERF.md
# section 6's table (H100 80GB HBM3, 700 W), printed beside this run's
# times.
K9_I2T_BEFORE_MS = {(16, 785): 0.0309, (20, 3137): 0.1254,
                    (64, 3137): 0.3805, (16, 981): 0.0374}
K7_BEFORE_MS = {(torch.bfloat16, 16 * 785, 768): 0.0171,
                (torch.bfloat16, 240, 768): 0.0025,
                (torch.bfloat16, 8 * 6273, 768): 0.0570,
                (torch.bfloat16, 64 * 3137, 768): 0.2172,
                (torch.bfloat16, 16 * 981, 768): 0.0205,
                (torch.float32, 32 * 256, 128): 0.0050,
                (torch.float32, 32 * 15, 128): 0.0017,
                (torch.float32, 20 * 200, 768): 0.0098}
# name -> (what changed, its time before, by (dtype, B, frames))
BEFORE_MS = {"cls_row_attention_fwd": ("the key runs", K3_BEFORE_MS),
             "cls_row_attention_bwd": ("the key runs", K6_BEFORE_MS),
             "time_attention_bwd": ("the tensor cores", K5_BEFORE_MS),
             "time_attention_fwd": ("the tensor cores", K2_BEFORE_MS),
             "space_attention_fwd": ("the frame form", K1_BEFORE_MS),
             "space_attention_bwd": ("the frame form", K4_BEFORE_MS)}
# K5's kernels by form, as the profiler names them
TIME_BWD_KERNELS = {"tensor_cores": ("time_bwd_kernel",),
                    "grouped": ("grouped_bwd_query_kernel",
                                "grouped_bwd_key_kernel")}
# K2's the same way, K1's and K4's, and K8's two launches
TIME_FWD_KERNELS = {"tensor_cores": ("time_fwd_tc_kernel",),
                    "grouped": ("time_fwd_kernel",)}
SPACE_FWD_KERNELS = {"frame": ("space_fwd_frame_kernel",),
                     "grouped": ("space_fwd_kernel",)}
SPACE_BWD_KERNELS = {"frame": ("space_bwd_frame_kernel",),
                     "grouped": ("grouped_bwd_query_kernel",
                                 "grouped_bwd_key_kernel")}
LN_BWD_KERNELS = ("layernorm_bwd_kernel", "layernorm_bwd_sum_kernel")
# of max |reference|, each against the plain version on the same values in
# f32 (the kernels keep P, dP and dS in f32 and round only the stores)
GENERAL_TOL = {torch.bfloat16: 2e-2, torch.float32: 1e-4}
# K10's lse, of max |reference|: f32 sums in another order (a bf16 input is
# exact in f32, so the same holds there)
GENERAL_LSE_TOL = 1e-5
L2_BYTES = 50e6  # timed LayerNorm calls walk input sets of 4x this in all
TIME_ITERS = 20  # timed calls of a kernel or its plain version, after 3 warm
# The card's published peaks (NVIDIA H100 SXM data sheet, dense).
PEAK_BYTES_S = 3.35e12
PEAK_FLOPS = {torch.bfloat16: 989e12, torch.float32: 67e12}
PRETRAIN_STEPS = 6
PRETRAIN_SETS = ["model.compute_dtype=bfloat16", "model.remat=false",
                 "path_remat=false", "optim.max_steps=1000",
                 "global_batch_size=16"]
# The multiprocess phase: pretrain at PRETRAIN_SETS under a group of one
# over NCCL, in a child process, as many steps as phase 5 so that both
# warm medians take steps 3 on; its later steps against those of the same
# run without a group within DIST_LOSS_RTOL (the embedding backward sums
# with atomics, as phase 6's FEED_LOSS_RTOL says), that run's step the
# eager one as under the group (phase 5's replays a CUDA graph, whose
# `capturable` AdamW rounds its bias corrections otherwise); the refusal of
# two ranks on the card within REFUSE_TIMEOUT seconds.
DIST_STEPS = PRETRAIN_STEPS
DIST_LOSS_RTOL = 1e-3
DIST_TIMEOUT = 300
REFUSE_TIMEOUT = 120
# The bench phase: `cli bench` at its defaults (bench.py's 3 warm and 10
# timed steps), the host syncs counted in its second timed step.
BENCH_WARMUP, BENCH_ITERS = 3, 10
BENCH_SYNC_STEP = BENCH_WARMUP + 2
BENCH_TIMEOUT = 300
BENCH_DRAWS = 3
FINETUNE_CONFIG = "configs/ft_charades.json"
FINETUNE_SETS = ["global_batch_size=8", "optim.max_steps=1000"]
FINETUNE_RUNS = (("ft_charades_32f", "model.remat=false", 5),
                 ("ft_charades_32f_remat", "model.remat=true", 2))
# K9 stays out of the fine-tune: its text attention drops probabilities in
# training, which is the plain path.
FINETUNE_KERNELS = tuple(k for k in BF16_PATH_KERNELS
                         if k != "fused_attention_fwd")
# The feed phase: 2 warm steps, 8 timed, then 2 under the profiler, at
# each prefetch depth (0: the put inline; 2: from device_prefetch's feeder
# thread), from the same seed.
FEED_WARM, FEED_TIMED, FEED_PROFILED = 2, 8, 2
FEED_DEPTHS = (0, 2)
# The losses of a step at the two depths: the same batches and weights, and
# the step's kernels give the same bits twice, but the backward of
# PyTorch's embedding and index ops sums with atomics in a run-dependent
# order, so the parameters, and later losses, may move in their last bits.
FEED_LOSS_RTOL = 1e-3
FEED_COPY_BYTES = 1 << 20  # a host-to-device copy of a batch's arrays
# Kernels at most this far apart make one busy period of the device: a
# host-bound step launches a kernel every few tens of µs; a compute stream
# that waits on a copy idles for the copy's milliseconds.
FEED_BUSY_GAP_US = 500.0
# The loop phase: pretrain at PRETRAIN_SETS, two epochs of LOOP_STEPS steps
# and a synthetic EgoMCQ validation of LOOP_VAL_BATCHES batches (4
# questions, 20 clips each) after each, the monitor on one of its scores.
LOOP_STEPS, LOOP_VAL_BATCHES = 2, 1
LOOP_MONITOR = "max:vtc/Inter-video"
LOOP_VAL_KERNELS = tuple(k for k in BF16_PATH_KERNELS if k.endswith("_fwd"))
EXTRACT_CONFIG = "configs/extract_mq.json"
EXTRACT_FRAMES = 2048  # 128 windows of 16 frames: two inner batches of 64
NLQ_QUERIES = ("where did I put the scissors", "what did I pour in the bowl")
QFVS_FRAMES, QFVS_INNER_BATCH = 400, 16
QFVS_CONCEPTS, QFVS_ORACLE = ("cup", "street"), "cup and street"
# EgoTaskQA: TrainConfig defaults (4 frames at 224, S=785, f32, 15 tokens),
# batch 8, seeded in-memory items over a synthetic answer set
TASKQA_STEPS, TASKQA_BATCH, TASKQA_ANSWERS, TASKQA_VAL_BATCHES = 5, 8, 100, 2
# The downstream heads (phase 8), at their published widths, on seeded files
# in the formats the readers take. EgoMQ: VSGN at T=928, 4096-d features, 5
# levels, 110 moment classes + background, batch 16; 32 training clips (2
# steps an epoch, 2 epochs) and 2 validation clips, each one window (the
# validation's loader drops a partial batch, so with 2 clips it has none,
# as the JAX orchestrator's: the best parameters stay the initial ones).
MQ_TRAIN_CLIPS, MQ_VAL_CLIPS, MQ_CLASSES, MQ_BATCH = 32, 2, 110, 16
MQ_FPS = 1.875  # the MQ features' rate: 16-frame windows of 30 fps video
# EgoNLQ: VSLNet at dim 128, max_pos_len 256, 768-d features, batch 32; 64
# training queries (2 steps an epoch, 2 epochs), 4 validation ones, 15
# query tokens. Each training step runs 26 LayerNorms forward and
# backward: 6 on the query rows (the feature encoder's), 20 on the video
# rows (6 of the feature encoder's, 12 of the predictor's, start and end).
NLQ_TRAIN, NLQ_VAL, NLQ_BATCH, NLQ_TOKENS = 64, 4, 32, 15
NLQ_LN_ROWS = {NLQ_BATCH * NLQ_TOKENS: 6, NLQ_BATCH * 256: 20}
# QFVS: the scorer at d_model 768 over 20 segments x 200 shots; 2 training
# videos with 2 concept pairs each (4 steps an epoch, 2 epochs), 1 held
# out; a step runs the scorer 3 times, 4 LayerNorms each, on 4,000 rows.
QFVS_SEGMENTS, QFVS_SHOTS, QFVS_PAIRS = 20, 200, (("Car", "Tree"),
                                                  ("Cupglass", "Sky"))
QFVS_LN_ROWS = {QFVS_SEGMENTS * QFVS_SHOTS: 12}
HEAD_EPOCHS = 2
HEAD_LN_KERNELS = ("layernorm_fwd", "layernorm_bwd")
QA_TYPES = ("descriptive", "predictive", "explanatory", "counterfactual")


def _device_events(fn) -> dict:
    """`fn` TIME_ITERS times under torch.profiler, after 3 warm calls: the
    device time a call, in ms, of each kernel or copy it ran, by name. A
    profile that holds no device event (the tracer now and then hands back
    none) is taken again, twice at most, and then raises."""
    for _ in range(3):
        fn()
    torch.cuda.synchronize()
    for _ in range(3):
        with profile(activities=[ProfilerActivity.CUDA]) as prof:
            for _ in range(TIME_ITERS):
                fn()
            torch.cuda.synchronize()
        events = {e.key: e.self_device_time_total / 1e3 / TIME_ITERS
                  for e in prof.key_averages()
                  if e.device_type == DeviceType.CUDA
                  and e.self_device_time_total}
        if events:
            return events
    raise AssertionError("torch.profiler recorded no device event in three "
                         "profiles of one call")


def _time_ms(fn) -> float:
    """The device time of a call of `fn`: all the kernels and copies it
    runs, from the profiler. A CUDA-event window over the calls would also
    take in the time the card waits for the host to issue the next call."""
    return sum(_device_events(fn).values())


def _window_ms(fn) -> tuple:
    """A CUDA-event window over TIME_ITERS calls of `fn`, a call, and the
    host's own time a call in the same loop (before it waits for the card):
    set beside `_time_ms`, they show what the window adds to the device
    time."""
    for _ in range(3):
        fn()
    torch.cuda.synchronize()
    start = torch.cuda.Event(enable_timing=True)
    end = torch.cuda.Event(enable_timing=True)
    start.record()
    t0 = time.perf_counter()
    for _ in range(TIME_ITERS):
        fn()
    host_ms = (time.perf_counter() - t0) * 1e3 / TIME_ITERS
    end.record()
    end.synchronize()
    return start.elapsed_time(end) / TIME_ITERS, host_ms


def bound_ms(name: str, dtype, b: int, s: int, frames: int) -> tuple:
    """The least time the card could take for one call: the larger of the
    bytes the function must move (each input row read once, each output row
    written once) over the memory rate, and its operations (2 a
    multiply-add; the forward has 2 products a (query, key) pair, the
    backward 5 with the recomputed logits) over the peak rate of the dtype.
    Returns (ms, "bytes" or "operations")."""
    e = torch.finfo(dtype).bits // 8
    head_rows = b * H * DH  # elements of one sequence row over all heads
    keys = {"space": N + 1, "time": frames + 1, "cls_row": s}[name.rsplit("_", 2)[0]]
    queries = 1 if name.startswith("cls_row") else s - 1
    if name.endswith("_fwd"):
        rows = queries + 2 * s + queries  # q, k and v in; out
        products = 2
    elif name.startswith("cls_row"):
        # q0, k, v and g0 in; dq0, dk and dv out. That K6 adds in place to
        # the 2 (S - 1) dk/dv rows K4/K5 wrote, and so reads them back, is
        # this design's cost and not the function's.
        rows = 1 + 2 * s + 1 + 1 + 2 * s
        products = 5
    else:
        rows = queries + 2 * s + queries + 3 * queries  # q, k, v, g; dq, dk, dv
        products = 5
    t_bytes = rows * head_rows * e / PEAK_BYTES_S
    t_flops = products * 2 * b * H * queries * keys * DH / PEAK_FLOPS[dtype]
    return max(t_bytes, t_flops) * 1e3, "bytes" if t_bytes >= t_flops else "operations"


def ln_bound_ms(name: str, dtype, rows: int, d: int) -> tuple:
    """The same for one LayerNorm call on x [rows, d]: the forward reads x,
    scale and bias and writes y; the backward reads x, g and scale and
    writes dx, dscale and dbias. Its arithmetic is float32 on the CUDA
    cores: about 8 operations an element forward (two sums, the
    normalisation, the affine), about 20 backward."""
    e = torch.finfo(dtype).bits // 8
    fwd = name.endswith("_fwd")
    t_bytes = ((2 if fwd else 3) * rows * d * e + (2 if fwd else 3) * d * 4) \
        / PEAK_BYTES_S
    t_flops = (8 if fwd else 20) * rows * d / PEAK_FLOPS[torch.float32]
    return max(t_bytes, t_flops) * 1e3, "bytes" if t_bytes >= t_flops else "operations"


def flash_bound_ms(dtype, b: int, h: int, sq: int, sk: int, dh: int,
                   masked: bool) -> tuple:
    """The same for one fused attention call: q, k, v and the [B, Sk] float32
    mask read once, the output written once; 4 * Sq * Sk * Dh operations a
    (batch, head) (two products, 2 a multiply-add)."""
    e = torch.finfo(dtype).bits // 8
    t_bytes = ((2 * sq + 2 * sk) * b * h * dh * e + masked * b * sk * 4) \
        / PEAK_BYTES_S
    t_flops = 4 * b * h * sq * sk * dh / PEAK_FLOPS[dtype]
    return max(t_bytes, t_flops) * 1e3, "bytes" if t_bytes >= t_flops else "operations"


def general_bound_ms(name: str, dtype, b: int, frames: int, n: int, h: int,
                     dh: int, axis: str) -> tuple:
    """The same for one call of K10 or K11 at S = 1 + frames * n, as the
    function's least work: the forward reads q, k, v and writes the output,
    the backward reads q, k, v and the cotangent and writes dq, dk, dv
    ([B, S, H, Dh] each; the output and lse that K11 also reads are this
    design's cost, not the function's); the operations are 4 Dh a live
    (query, key) pair forward (two products, 2 a multiply-add) and 10 Dh
    backward (five products), over the pairs this function has: row 0
    against all S keys, a patch row against the CLS key and its group (N
    keys on the space axis, F on the time axis). Returns (ms, "bytes" or
    "operations")."""
    e = torch.finfo(dtype).bits // 8
    s = 1 + frames * n
    pairs = s + (s - 1) * (1 + (n if axis == "space" else frames))
    fwd = name.endswith("_fwd")
    t_bytes = (4 if fwd else 7) * b * s * h * dh * e / PEAK_BYTES_S
    t_flops = (4 if fwd else 10) * dh * pairs * b * h / PEAK_FLOPS[dtype]
    return max(t_bytes, t_flops) * 1e3, "bytes" if t_bytes >= t_flops else "operations"


def _reset_counts() -> None:
    _kernels.reset_launch_counts()
    ln.contiguous_copies.update(x=0, g=0)
    flash.contiguous_copies.update(q=0, k=0, v=0, bias=0)


def _hand_kernels() -> set:
    """The `__global__` names of the hand-written kernels in `csrc/`."""
    names = set()
    for src in Path(_kernels.__file__).resolve().parents[1].glob(
            "csrc/*.cu"):
        names |= set(re.findall(r"__global__\s+void\s+(?:__launch_bounds__"
                                r"\((?:[^()]|\([^()]*\))*\)\s+)?(\w+)\s*\(",
                                src.read_text()))
    return names


def _hand_launches(prof) -> dict:
    """The device's launches of each hand-written kernel in a profile, by
    its `__global__` name (the profiler's is demangled: "void
    (anonymous namespace)::name<...>(...)")."""
    hand, out = _hand_kernels(), {}
    for e in prof.events():
        if e.device_type == DeviceType.CUDA:
            for name in set(re.findall(r"\w+", e.name)) & hand:
                out[name] = out.get(name, 0) + 1
    return dict(sorted(out.items()))


def _step_kinds(mark: int) -> list:
    """How each training step since span `mark` ran, in order: "eager",
    "capture" (the call that captured the step's CUDA graph, then replayed
    it) or "replay". The kernels' wrappers count launches in the eager and
    capturing steps alone: a replay calls none."""
    names = {}
    for s in SPANS.records(mark):
        names.setdefault(s.step, set()).add(s.name)
    return ["capture" if CAPTURE in n else "replay" if REPLAY in n
            else "eager" for _, n in sorted(names.items()) if STEP in n]


def _python_steps(kinds: list) -> int:
    """The steps of `kinds` (`_step_kinds`) whose wrappers ran."""
    return sum(k != "replay" for k in kinds)


@contextlib.contextmanager
def _witnessed(module, name: str, calls: tuple):
    """Wraps `module.<name>`, a builder of (model, optimizer, scheduler,
    step): the calls numbered in `calls` (from 1) of each step it builds
    run under torch.profiler. Yields a dict, filled as the block runs: call
    number -> (how that call's step ran, `_step_kinds`; its
    `_hand_launches`). A replayed step's kernels are seen so alone."""
    plain, seen = getattr(module, name), {}

    def build(*args, **kwargs):
        *rest, step = plain(*args, **kwargs)
        n = 0

        def call(batch):
            nonlocal n
            n += 1
            if n not in calls:
                return step(batch)
            mark = SPANS.last
            with profile(activities=[ProfilerActivity.CUDA]) as prof:
                out = step(batch)
                torch.cuda.synchronize()
            seen[n] = (_step_kinds(mark), _hand_launches(prof))
            return out

        call.generator = step.generator
        call.mining_generator = step.mining_generator
        return (*rest, call)

    setattr(module, name, build)
    try:
        yield seen
    finally:
        setattr(module, name, plain)


def _check_witness(label: str, seen: dict, first: int, later: int) -> None:
    """The hand kernels of call `later` (a replay where the step captures)
    are those of call `first` (eager), launch for launch, and not none."""
    (k1, a), (k2, b) = seen[first], seen[later]
    if k1 != ["eager"] or not a or a != b:
        raise AssertionError(f"{label}: hand kernels of call {first} {k1} "
                             f"{a} against call {later} {k2} {b}")


def _free() -> None:
    """Drop what the last phase left on the card before the next builds."""
    gc.collect()
    torch.cuda.empty_cache()


def phase_device() -> str:
    if not torch.cuda.is_available():
        raise SystemExit("chip_smoke: torch.cuda.is_available() is False")
    smi = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
        capture_output=True, text=True, check=True, timeout=60).stdout.strip()
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    name = torch.cuda.get_device_name(0)
    print(f"[1 device] {name} x{torch.cuda.device_count()}, torch "
          f"{torch.__version__}, CUDA {torch.version.cuda}, python "
          f"{sys.version.split()[0]}; nvidia-smi: {smi}", flush=True)
    return smi


def phase_build() -> None:
    t0 = time.perf_counter()
    cached = all(p.exists() for p in _kernels.library_paths().values())
    _kernels.load()
    libs = ", ".join(p.name for p in _kernels.library_paths().values())
    print(f"[2 build] {time.perf_counter() - t0:.2f} s "
          f"({'already built' if cached else 'nvcc'}): {libs}", flush=True)


def _grouped_qkv(qkv: torch.Tensor, axis: str, frames: int):
    """q, k, v as one library attention call takes them: the frames (space)
    or patch columns (time) as a batch [B, H, G, L, Dh], the CLS key and
    value concatenated in front of each group's."""
    b, s, _, h, dh = qkv.shape
    q, k, v = qkv.permute(2, 0, 3, 1, 4).unbind(0)

    def grouped(t):
        t = t[:, :, 1:].reshape(b, h, frames, (s - 1) // frames, dh)
        return t.transpose(2, 3) if axis == "time" else t

    qg, kg, vg = grouped(q), grouped(k), grouped(v)
    g = qg.shape[2]
    kg = torch.cat([k[:, :, None, :1].expand(b, h, g, 1, dh), kg], dim=3)
    vg = torch.cat([v[:, :, None, :1].expand(b, h, g, 1, dh), vg], dim=3)
    return qg.contiguous(), kg.contiguous(), vg.contiguous()


def _library_calls(qkv: torch.Tensor, g: torch.Tensor, frames: int) -> dict:
    """name -> a closure over one PyTorch library call that computes the
    kernel's function (`scaled_dot_product_attention`, or its autograd
    backward), on tensors laid out for it beforehand. Timed only."""
    scale = DH ** -0.5
    calls = {}
    q0, k0, v0 = (t.contiguous() for t in qkv.permute(2, 0, 3, 1, 4).unbind(0))
    groups = {"space": _grouped_qkv(qkv, "space", frames),
              "time": _grouped_qkv(qkv, "time", frames),
              "cls_row": (q0[:, :, :1].contiguous(), k0, v0)}
    b, s = qkv.shape[:2]
    gh = g.transpose(1, 2)  # [B, H, S, Dh]
    cots = {"space": gh[:, :, 1:].reshape(b, H, frames, -1, DH),
            "time": gh[:, :, 1:].reshape(b, H, frames, -1, DH).transpose(2, 3),
            "cls_row": gh[:, :, :1]}
    for axis, (q, k, v) in groups.items():
        calls[f"{axis}_attention_fwd"] = (
            lambda q=q, k=k, v=v: F.scaled_dot_product_attention(
                q, k, v, scale=scale))
        leaves = [t.detach().requires_grad_(True) for t in (q, k, v)]
        out = F.scaled_dot_product_attention(*leaves, scale=scale)
        cot = cots[axis].contiguous()
        calls[f"{axis}_attention_bwd"] = (
            lambda out=out, leaves=leaves, cot=cot: torch.autograd.grad(
                out, leaves, cot, retain_graph=True))
    return calls


def _rel_errs(got: torch.Tensor, ref: torch.Tensor) -> tuple:
    """(largest abs error, its share of max |ref| on the CLS row, the same
    on the patch rows) over dq, dk, dv of [B, S, 3, H, Dh] tensors. Sequence
    row 0 and rows 1..S-1 are each held to their own max |ref|: the CLS key
    gathers from every query, so its dk/dv are many times a patch key's and
    would hide an error as large as a patch row's values."""
    worst_abs, worst_rel = 0.0, [0.0, 0.0]
    for i in range(3):
        for j, rows in enumerate((slice(0, 1), slice(1, None))):
            r = ref[:, rows, i].float()
            err = (got[:, rows, i].float() - r).abs().max().item()
            worst_abs = max(worst_abs, err)
            worst_rel[j] = max(worst_rel[j], err / max(r.abs().max().item(), 1e-30))
    return worst_abs, worst_rel[0], worst_rel[1]


def phase_kernels() -> dict:
    """Each kernel against its plain version; returns per-kernel results,
    with the times taken at MAIN_CASE."""
    results = {name: {"max_abs_err": 0.0} for name in KERNELS}
    gen = torch.Generator(device="cuda").manual_seed(0)
    scale = DH ** -0.5

    def record(name, dtype, b, frames, err, check, ms, plain_ms, lib_ms):
        s = 1 + frames * N
        least, by = bound_ms(name, dtype, b, s, frames)
        tag = f"{str(dtype).split('.')[-1]} B={b} S={s}"
        what, times = BEFORE_MS.get(name, ("", {}))
        before = times.get((dtype, b, frames))
        was = "" if before is None else (
            f" (before {what}: {before:.4f} ms; bitwise equal twice)")
        print(f"[3 kernels] {name:22s} {tag:20s} err={err:.3e} ({check}, tol "
              f"{TOL[dtype]:.0e})  kernel {ms:.4f} ms{was}  plain "
              f"{plain_ms:.4f} ms  library {lib_ms:.4f} ms  bound "
              f"{least:.4f} ms ({by})", flush=True)
        r = results[name]
        r["max_abs_err"] = max(r["max_abs_err"], err)
        if (dtype, b, frames) == MAIN_CASE:
            r.update(ms=ms, plain_ms=plain_ms, library_ms=lib_ms,
                     bound_ms=least, bound_by=by, shape=tag)

    for dtype in (torch.bfloat16, torch.float32):
        for b, frames in sorted(set(FWD_CASES) | set(BWD_CASES)):
            s = 1 + frames * N
            qkv = torch.randn((b, s, 3, H, DH), generator=gen,
                              device="cuda").to(dtype)
            g = torch.randn((b, s, H, DH), generator=gen,
                            device="cuda").to(dtype)
            flat, gflat = qkv.view(b, s, 3 * H * DH), g.view(b, s, H * DH)
            library = _library_calls(qkv, g, frames)
            kw = dict(num_heads=H, num_frames=frames, scale=scale)
            ckw = dict(num_heads=H, scale=scale)

            if (b, frames) in FWD_CASES:
                out = torch.empty((b, s, H * DH), dtype=dtype, device="cuda")
                lse0 = torch.empty((b, H), device="cuda")
                # (kernel, plain version as timed, the same on `x`, rows)
                runs = {
                    "space_attention_fwd": (
                        lambda: _kernels.space_attention_fwd(flat, out, **kw),
                        lambda x=qkv: grouped_reference(
                            x, scale=scale, axis="space", num_frames=frames),
                        slice(1, None)),
                    "time_attention_fwd": (
                        lambda: _kernels.time_attention_fwd(flat, out, **kw),
                        lambda x=qkv: grouped_reference(
                            x, scale=scale, axis="time", num_frames=frames),
                        slice(1, None)),
                    "cls_row_attention_fwd": (
                        lambda: _kernels.cls_row_attention_fwd(flat, out, lse0,
                                                               **ckw),
                        lambda x=qkv: cls_row_reference(x, scale=scale),
                        slice(0, 1)),
                }
                for name, (kernel, plain, rows) in runs.items():
                    out.fill_(float("nan"))
                    kernel()
                    torch.cuda.synchronize()
                    # held to the plain version on the same values in f32
                    ref = plain(qkv.float()).reshape(b, -1, H * DH)
                    got = out[:, rows]
                    if not torch.isfinite(got).all():
                        raise AssertionError(f"{name}: non-finite output rows")
                    err = (got.float() - ref.float()).abs().max().item()
                    if not err <= TOL[dtype]:
                        raise AssertionError(f"{name} {dtype} B={b} S={s}: "
                                             f"error {err} > {TOL[dtype]}")
                    check = "abs"
                    if name == "cls_row_attention_fwd":
                        check += _check_cls_row_fwd(qkv, flat, out, lse0)
                    events = _device_events(kernel)
                    if name == "time_attention_fwd":
                        check += _check_time_fwd(flat, out, kw, events)
                    if name == "space_attention_fwd":
                        check += _check_space_fwd(flat, out, kw, events)
                    record(name, dtype, b, frames, err, check,
                           sum(events.values()), _time_ms(plain),
                           _time_ms(library[name]))

            if (b, frames) in BWD_CASES:
                dqkv = torch.empty_like(flat)
                for axis in ("space", "time"):
                    name = f"{axis}_attention_bwd"
                    stats, parts = _kernels.attention_bwd_scratch(
                        flat, num_heads=H, num_frames=frames, axis=axis)
                    launch = getattr(_kernels, name)
                    kernel = lambda: launch(flat, gflat, dqkv, stats, parts, **kw)
                    plain = lambda: divided_attention_backward_reference(
                        qkv, g, scale=scale, axis=axis, num_frames=frames,
                        rows="grouped")
                    dqkv.fill_(float("nan"))
                    kernel()
                    torch.cuda.synchronize()
                    got = dqkv.view(b, s, 3, H, DH).clone()
                    if not torch.isnan(got[:, 0]).all():
                        raise AssertionError(f"{name} wrote sequence row 0")
                    # row 0: dq is 0 for the grouped rows; dk/dv of the CLS
                    # key are the sum of the blocks' partials (K6 adds them)
                    got[:, 0, 0] = 0
                    got[:, 0, 1:] = parts.sum(2).permute(0, 2, 1, 3).to(dtype)
                    if not torch.isfinite(got).all():
                        raise AssertionError(f"{name}: non-finite gradient")
                    err, rel_cls, rel = _rel_errs(got, plain())
                    if not max(rel_cls, rel) <= TOL[dtype]:
                        raise AssertionError(
                            f"{name} {dtype} B={b} S={s}: relative error CLS "
                            f"row {rel_cls}, patch rows {rel} > {TOL[dtype]}")
                    check = f"rel cls row {rel_cls:.2e} patch rows {rel:.2e}"
                    events = _device_events(kernel)
                    if axis == "time":
                        check += _check_time_bwd(flat, gflat, dqkv, parts, kw,
                                                 events)
                    else:
                        check += _check_space_bwd(qkv, g, flat, gflat, dqkv,
                                                  parts, kw, events)
                        space_parts = parts
                    record(name, dtype, b, frames, err, check,
                           sum(events.values()), _time_ms(plain),
                           _time_ms(library[name]))
                name = "cls_row_attention_bwd"
                # fed K3's output and lse0, as the autograd Function runs it
                out0 = torch.empty((b, s, H * DH), dtype=dtype, device="cuda")
                lse0 = torch.empty((b, H), device="cuda")
                _kernels.cls_row_attention_fwd(flat, out0, lse0, **ckw)
                dqkv.zero_()
                dqkv_again = torch.zeros_like(dqkv)
                zero_parts = torch.zeros_like(parts)
                for d in (dqkv, dqkv_again):
                    _kernels.cls_row_attention_bwd(flat, gflat, out0, lse0, d,
                                                   zero_parts, **ckw)
                torch.cuda.synchronize()
                # no atomics: two runs on one input give the same bits
                if not _same_bits(dqkv, dqkv_again):
                    raise AssertionError(f"{name} {dtype} B={b} S={s}: two "
                                         f"runs on one input differ")
                plain = lambda: divided_attention_backward_reference(
                    qkv, g, scale=scale, axis="space", num_frames=frames,
                    rows="cls")
                err, rel_cls, rel = _rel_errs(dqkv.view(b, s, 3, H, DH), plain())
                if not max(rel_cls, rel) <= TOL[dtype]:
                    raise AssertionError(
                        f"{name} {dtype} B={b} S={s}: relative error CLS row "
                        f"{rel_cls}, patch rows {rel} > {TOL[dtype]}")
                del dqkv_again, zero_parts
                # K6 after K4 as the autograd Function runs them, fed K4's
                # `cls_part` (one row a frame in the frame form): the whole
                # space-axis gradient
                _kernels.space_attention_bwd(flat, gflat, dqkv, stats,
                                             space_parts, **kw)
                _kernels.cls_row_attention_bwd(flat, gflat, out0, lse0, dqkv,
                                               space_parts, **ckw)
                torch.cuda.synchronize()
                _, rel_cls_all, rel_all = _rel_errs(
                    dqkv.view(b, s, 3, H, DH),
                    divided_attention_backward_reference(
                        qkv, g, scale=scale, axis="space", num_frames=frames))
                if not max(rel_cls_all, rel_all) <= TOL[dtype]:
                    raise AssertionError(
                        f"K6 after K4 {dtype} B={b} S={s}: relative error CLS "
                        f"row {rel_cls_all}, patch rows {rel_all} > "
                        f"{TOL[dtype]}")
                # timed as the step runs it: adding to rows K4/K5 wrote
                kernel = lambda: _kernels.cls_row_attention_bwd(
                    flat, gflat, out0, lse0, dqkv, parts, **ckw)
                record(name, dtype, b, frames, err,
                       f"rel cls row {rel_cls:.2e} patch rows {rel:.2e}; "
                       f"after K4 ({space_parts.shape[2]} cls_part rows) rel "
                       f"cls row {rel_cls_all:.2e} patch rows {rel_all:.2e}",
                       _time_ms(kernel), _time_ms(plain),
                       _time_ms(library[name]))
            del library
            torch.cuda.empty_cache()
    phase_layernorm(results)
    phase_flash(results)
    phase_general(results)
    return results


def _check_time_bwd(flat, gflat, dqkv, parts, kw, events) -> str:
    """K5 (from the call just made into `dqkv` and `parts`) a second time on
    the same input: the same bits in dqkv and in the CLS-key partials (each
    block sums its columns in order, no atomics); and `events`, the
    profiled kernels of a call, are those of the form `time_bwd_geometry`
    names. Returns the check's text."""
    b, s = flat.shape[:2]
    dqkv_again = torch.full_like(dqkv, float("nan"))
    parts_again = torch.full_like(parts, float("nan"))
    stats = torch.empty((2, b, H, s), device="cuda")
    _kernels.time_attention_bwd(flat, gflat, dqkv_again, stats, parts_again,
                                **kw)
    torch.cuda.synchronize()
    if not (_same_bits(dqkv, dqkv_again) and _same_bits(parts, parts_again)):
        raise AssertionError(f"time_attention_bwd B={b} S={s}: two runs on "
                             f"one input differ")
    form = _kernels.time_bwd_geometry(flat.dtype, DH, s,
                                      kw["num_frames"]).form
    _check_kernels("time_attention_bwd", b, s, form, TIME_BWD_KERNELS[form],
                   events)
    return f"; {form} form, bitwise equal twice"


def _check_space_bwd(qkv, g, flat, gflat, dqkv, parts, kw, events) -> str:
    """K4 (from the call just made into `dqkv` and `parts`) a second time on
    the same input: the same bits in dqkv and in the CLS-key partials (no
    atomics); `events`, the profiled kernels of a call, are those of the
    form `space_bwd_geometry` names (the frame form one launch), and
    `parts` has its parts: F in the frame form. The frame form is also held
    to the plain version of its block, `space_frame_grad_reference` (P, dP,
    delta and dS in f32; P rounded only before dV, dS only before dQ/dK):
    dq, dk, dv of the patch rows and `cls_part`'s dk, dv each within
    TOL of its max |reference|. Returns the check's text."""
    b, s = flat.shape[:2]
    frames = kw["num_frames"]
    geo = _kernels.space_bwd_geometry(flat.dtype, DH, s, frames)
    twin = ""
    if geo.form == "frame":
        want, want_cls = space_frame_grad_reference(
            qkv, g, scale=kw["scale"], num_frames=frames)
        got = dqkv.view(b, s, 3, H, DH)[:, 1:].float()
        errs = [((got[:, :, i] - want[:, 1:, i]).abs().max()
                 / want[:, 1:, i].abs().max()).item() for i in range(3)]
        errs += [((parts[:, :, :, i] - want_cls[:, :, :, i]).abs().max()
                  / want_cls[:, :, :, i].abs().max()).item() for i in range(2)]
        del want, want_cls, got
        if not max(errs) <= TOL[flat.dtype]:
            raise AssertionError(f"space_attention_bwd B={b} S={s}: relative "
                                 f"error against its frame block's plain "
                                 f"version {errs} > {TOL[flat.dtype]}")
        twin = f"; frame block's plain version rel {max(errs):.2e}"
    if parts.shape[2] != geo.parts or (geo.form == "frame"
                                       and geo.parts != frames):
        raise AssertionError(f"space_attention_bwd B={b} S={s}: cls_part has "
                             f"{parts.shape[2]} parts, the {geo.form} form "
                             f"{geo.parts}")
    dqkv_again = torch.full_like(dqkv, float("nan"))
    parts_again = torch.full_like(parts, float("nan"))
    stats = torch.empty((2, b, H, s), device="cuda")
    _kernels.space_attention_bwd(flat, gflat, dqkv_again, stats, parts_again,
                                 **kw)
    torch.cuda.synchronize()
    if not (_same_bits(dqkv, dqkv_again) and _same_bits(parts, parts_again)):
        raise AssertionError(f"space_attention_bwd B={b} S={s}: two runs on "
                             f"one input differ")
    _check_kernels("space_attention_bwd", b, s, geo.form,
                   SPACE_BWD_KERNELS[geo.form], events)
    return (f"; {geo.form} form ({len(SPACE_BWD_KERNELS[geo.form])} launch"
            f"{'es' if geo.form == 'grouped' else ''}, {geo.parts} parts), "
            f"bitwise equal twice{twin}")


def _check_space_fwd(flat, out, kw, events) -> str:
    """K1 (from the call just made into `out`) a second time on the same
    input: the same bits; and `events`, the profiled kernels of a call, are
    those of the form `space_fwd_geometry` names. Returns the check's
    text."""
    b, s = flat.shape[:2]
    again = torch.full_like(out, float("nan"))
    _kernels.space_attention_fwd(flat, again, **kw)
    torch.cuda.synchronize()
    if not _same_bits(out[:, 1:], again[:, 1:]):
        raise AssertionError(f"space_attention_fwd B={b} S={s}: two runs on "
                             f"one input differ")
    form = _kernels.space_fwd_geometry(flat.dtype, DH, s,
                                       kw["num_frames"]).form
    _check_kernels("space_attention_fwd", b, s, form, SPACE_FWD_KERNELS[form],
                   events)
    return f"; {form} form, bitwise equal twice"


def _check_time_fwd(flat, out, kw, events) -> str:
    """K2 (from the call just made into `out`) a second time on the same
    input: the same bits; and `events`, the profiled kernels of a call, are
    those of the form `time_fwd_geometry` names. Returns the check's
    text."""
    b, s = flat.shape[:2]
    again = torch.full_like(out, float("nan"))
    _kernels.time_attention_fwd(flat, again, **kw)
    torch.cuda.synchronize()
    if not _same_bits(out[:, 1:], again[:, 1:]):
        raise AssertionError(f"time_attention_fwd B={b} S={s}: two runs on "
                             f"one input differ")
    geo = _kernels.time_fwd_geometry(flat.dtype, DH, s, kw["num_frames"])
    _check_kernels("time_attention_fwd", b, s, geo.form,
                   TIME_FWD_KERNELS[geo.form], events)
    if geo.form == "grouped":
        return "; grouped form, bitwise equal twice"
    return f"; tensor-core form ({geo.cols} cols a warp), bitwise equal twice"


def _check_kernels(name: str, b: int, s: int, form: str, kernels: tuple,
                   events: dict) -> None:
    """`events`, the profiled kernels of a call, are `kernels`, those of
    `form`, and no other. (b, s) name the shape: B and S, or R and D."""
    ran = {k for k in kernels if any(k in e for e in events)}
    if ran != set(kernels) or len(events) != len(ran):
        raise AssertionError(f"{name} at {b}, {s}: the {form} form should "
                             f"run {kernels}, the profiler saw "
                             f"{sorted(events)}")


def _check_cls_row_fwd(qkv, flat, out, lse0) -> str:
    """K3's lse0 (from the call just made) against row 0 of
    `row_lse_reference` within GENERAL_LSE_TOL of max |reference|, and a
    second K3 call on the same input: the same bits in row 0 and lse0 (the
    partials are merged in a fixed order, no atomics). Returns the check's
    text."""
    b = qkv.shape[0]
    scale = DH ** -0.5
    out_again = torch.full_like(out, float("nan"))
    lse_again = torch.full_like(lse0, float("nan"))
    _kernels.cls_row_attention_fwd(flat, out_again, lse_again, num_heads=H,
                                   scale=scale)
    torch.cuda.synchronize()
    if not (_same_bits(out[:, :1], out_again[:, :1])
            and _same_bits(lse0, lse_again)):
        raise AssertionError(f"cls_row_attention_fwd B={b}: two runs on one "
                             f"input differ")
    if not torch.isnan(out_again[:, 1:]).all():
        raise AssertionError("cls_row_attention_fwd wrote rows past row 0")
    # row 0 of `row_lse_reference`, without its [S, S] logits
    x = qkv.float()
    ref = (torch.einsum("bhd,bshd->bhs", x[:, 0, 0], x[:, :, 1])
           * scale).logsumexp(-1)
    rel = ((lse0 - ref).abs().max() / ref.abs().max()).item()
    if not rel <= GENERAL_LSE_TOL:
        raise AssertionError(f"cls_row_attention_fwd B={b}: lse0 error {rel} "
                             f"of max |reference| > {GENERAL_LSE_TOL}")
    return f", lse0 rel {rel:.2e} (tol {GENERAL_LSE_TOL:.0e})"


def phase_layernorm(results: dict) -> None:
    """K7 and K8 against their plain versions at LN_CASES (eps LN_EPS) and
    at HEAD_LN_CASES (f32, eps 1e-6); the times of LN_MAIN_CASE go into
    `results`, those of the heads' cases under "heads"."""
    gen = torch.Generator(device="cuda").manual_seed(1)

    def rel(got, ref):
        ref = ref.float()
        return ((got.float() - ref).abs().max() / ref.abs().max().clamp_min(1e-30)).item()

    for dtype, (rows, d), epses in ((dt, case, epses)
                                    for dtypes, cases, epses in LN_RUNS
                                    for dt in dtypes for case in cases):
        e = torch.finfo(dtype).bits // 8
        n_sets = int(min(8, max(1, -(-4 * L2_BYTES // (3 * rows * d * e)))))
        sets = []
        for _ in range(n_sets):
            # an offset mean: E[x^2] - E[x]^2 is then not a two-pass variance
            x = (torch.randn((rows, d), generator=gen, device="cuda") * 0.7
                 + 1.5).to(dtype)
            g = torch.randn((rows, d), generator=gen, device="cuda").to(dtype)
            sets.append((x, g, torch.empty_like(x), torch.empty_like(x)))
        scale = 1 + 0.2 * torch.randn(d, generator=gen, device="cuda")
        bias = 0.2 * torch.randn(d, generator=gen, device="cuda")
        dscale, dbias = torch.empty_like(scale), torch.empty_like(scale)
        partials = _kernels.layernorm_bwd_scratch(sets[0][0])
        x, g, y, dx = sets[0]
        errs = {"layernorm_fwd": 0.0, "layernorm_bwd": 0.0}
        checks = {}
        for eps in epses:
            y.fill_(float("nan"))
            dx.fill_(float("nan"))
            dscale.fill_(float("nan"))
            dbias.fill_(float("nan"))
            _kernels.layernorm_fwd(x, scale, bias, y, eps=eps)
            _kernels.layernorm_bwd(x, scale, g, dx, dscale, dbias, partials,
                                   eps=eps)
            torch.cuda.synchronize()
            ref_y = ln.layernorm_reference(x, scale, bias, eps=eps)
            ref_dx, ref_ds, ref_db = ln.layernorm_backward_reference(
                x, scale, g, eps)
            for t in (y, dx, dscale, dbias):
                if not torch.isfinite(t).all():
                    raise AssertionError(f"layernorm {dtype} {rows}x{d} eps "
                                         f"{eps}: non-finite output")
            r_y, r_dx = rel(y, ref_y), rel(dx, ref_dx)
            r_ds, r_db = rel(dscale, ref_ds), rel(dbias, ref_db)
            if not (max(r_y, r_dx) <= LN_TOL[dtype]
                    and max(r_ds, r_db) <= LN_SUM_TOL):
                raise AssertionError(
                    f"layernorm {dtype} {rows}x{d} eps {eps}: relative "
                    f"error y {r_y}, dx {r_dx} > {LN_TOL[dtype]} or dscale "
                    f"{r_ds}, dbias {r_db} > {LN_SUM_TOL}")
            errs["layernorm_fwd"] = max(
                errs["layernorm_fwd"], (y.float() - ref_y.float()).abs().max().item())
            errs["layernorm_bwd"] = max(
                errs["layernorm_bwd"], (dx.float() - ref_dx.float()).abs().max().item())
            checks[eps] = (f"rel y {r_y:.2e}", f"rel dx {r_dx:.2e} dscale "
                           f"{r_ds:.2e} dbias {r_db:.2e}")

        eps = epses[0]
        turn = {"i": 0}

        def next_set():
            turn["i"] += 1
            return sets[turn["i"] % n_sets]

        # the library call takes its parameters in x's dtype
        w, b = scale.to(dtype), bias.to(dtype)
        graphs = []
        for x_, g_, _, _ in sets:
            leaves = [t.detach().requires_grad_(True) for t in (x_, w, b)]
            graphs.append((F.layer_norm(leaves[0], (d,), leaves[1], leaves[2],
                                        eps), leaves, g_))

        def kernel_fwd():
            x_, _, y_, _ = next_set()
            _kernels.layernorm_fwd(x_, scale, bias, y_, eps=eps)

        def kernel_bwd():
            x_, g_, _, dx_ = next_set()
            _kernels.layernorm_bwd(x_, scale, g_, dx_, dscale, dbias, partials,
                                   eps=eps)

        def plain_bwd():
            x_, g_, _, _ = next_set()
            ln.layernorm_backward_reference(x_, scale, g_, eps)

        def library_bwd():
            out, leaves, g_ = graphs[(turn["i"] + 1) % n_sets]
            turn["i"] += 1
            torch.autograd.grad(out, leaves, g_, retain_graph=True)

        runs = {
            "layernorm_fwd": (
                kernel_fwd,
                lambda: ln.layernorm_reference(next_set()[0], scale, bias, eps=eps),
                lambda: F.layer_norm(next_set()[0], (d,), w, b, eps)),
            "layernorm_bwd": (kernel_bwd, plain_bwd, library_bwd),
        }
        for i, (name, (kernel, plain, library)) in enumerate(runs.items()):
            events = _device_events(kernel)
            ms, plain_ms, lib_ms = sum(events.values()), _time_ms(plain), _time_ms(library)
            least, by = ln_bound_ms(name, dtype, rows, d)
            tag = f"{str(dtype).split('.')[-1]} R={rows} D={d}"
            check = "; ".join(f"eps {k:g}: {v[i]}" for k, v in checks.items())
            if name == "layernorm_bwd":
                check += _check_layernorm_bwd(x, scale, g, partials, eps,
                                              events)
            else:
                check += _check_layernorm_fwd(x, scale, bias, eps, events,
                                              kernel)
            print(f"[3 kernels] {name:22s} {tag:24s} err={errs[name]:.3e} "
                  f"({check}; tol {LN_TOL[dtype]:.0e}, sums {LN_SUM_TOL:.0e})  "
                  f"kernel {ms:.4f} ms  plain {plain_ms:.4f} ms  library "
                  f"{lib_ms:.4f} ms  bound {least:.4f} ms ({by})  "
                  f"[{n_sets} input sets]", flush=True)
            r = results[name]
            r["max_abs_err"] = max(r["max_abs_err"], errs[name])
            if (dtype, rows, d) == LN_MAIN_CASE:
                r.update(ms=ms, plain_ms=plain_ms, library_ms=lib_ms,
                         bound_ms=least, bound_by=by, shape=tag)
            if (rows, d) in HEAD_LN_CASES:
                r.setdefault("heads", {})[f"R={rows} D={d} eps {eps:g}"] = \
                    dict(ms=ms, plain_ms=plain_ms, library_ms=lib_ms,
                         bound_ms=least, bound_by=by, max_abs_err=errs[name])
        del sets, graphs
        torch.cuda.empty_cache()


def _check_layernorm_fwd(x, scale, bias, eps, events, kernel) -> str:
    """K7 twice on one input: the same bits; `events`, the profiled kernels
    of a call, are its one launch; then the host's time a call of the
    wrapper (`kernel`) beside an event window, and its time before its
    redesign where PERF.md has one. Returns the check's text."""
    rows, d = x.shape
    runs = []
    for _ in range(2):
        runs.append(torch.full_like(x, float("nan")))
        _kernels.layernorm_fwd(x, scale, bias, runs[-1], eps=eps)
    torch.cuda.synchronize()
    if not _same_bits(*runs):
        raise AssertionError(f"layernorm_fwd R={rows} D={d}: two runs on one "
                             f"input differ")
    _check_kernels("layernorm_fwd", rows, d, "one-launch",
                   ("layernorm_fwd_kernel",), events)
    geo = _kernels.layernorm_fwd_geometry(x.dtype, rows, d)
    window_ms, host_ms = _window_ms(kernel)
    before = K7_BEFORE_MS.get((x.dtype, rows, d))
    before = "" if before is None else f", before its redesign {before:.4f} ms"
    return (f"; {geo.slots} pieces a thread, bitwise equal twice; an event "
            f"window {window_ms:.4f} ms and the host {host_ms:.4f} ms a "
            f"call{before}")


def _check_layernorm_bwd(x, scale, g, partials, eps, events) -> str:
    """K8 twice on one input: the same bits in dx, dscale and dbias (the
    blocks' sums are added in a fixed order, no atomics); and `events`, the
    profiled kernels of a call, are its two launches. Returns the check's
    text."""
    rows, d = x.shape
    runs = []
    for _ in range(2):
        out = (torch.full_like(x, float("nan")),
               torch.full_like(scale, float("nan")),
               torch.full_like(scale, float("nan")))
        _kernels.layernorm_bwd(x, scale, g, *out, partials, eps=eps)
        runs.append(out)
    torch.cuda.synchronize()
    if not all(_same_bits(a, b) for a, b in zip(*runs)):
        raise AssertionError(f"layernorm_bwd R={rows} D={d}: two runs on one "
                             f"input differ")
    geo = _kernels.layernorm_bwd_geometry(x.dtype, rows, d)
    _check_kernels("layernorm_bwd", rows, d, "two-launch", LN_BWD_KERNELS,
                   events)
    return f"; {geo.parts} blocks, bitwise equal twice"


def _flash_inputs(gen, dtype, b, h, sq, sk, dh, layout, masked):
    """q, k, v [B, H, S, Dh] as the models hand them to `attend`, and the
    [B, 1, 1, Sk] padding mask (batch row 0 fully masked)."""
    def proj(s, parts=1):
        return torch.randn((b, s, parts, h, dh), generator=gen,
                           device="cuda").to(dtype)

    q = proj(sq)[:, :, 0].transpose(1, 2)
    if layout == "packed":
        kv = proj(sk, 2).permute(2, 0, 3, 1, 4)
        k, v = kv[0], kv[1]
    else:
        k, v = (proj(sk)[:, :, 0].transpose(1, 2) for _ in range(2))
    bias = None
    if masked:
        mask = torch.rand((b, sk), generator=gen, device="cuda") > 0.3
        mask[:, 0] = True
        mask[0] = False
        if masked == "split":
            run = _kernels.flash_fwd_geometry(torch.bfloat16, dh, sq, sk, b,
                                              h).run
            mask[1, run:2 * run] = False
        bias = make_additive_mask(mask.long())
    return q, k, v, bias


def _check_flash_launches(q, k, got, events, kernel) -> str:
    """`events`, the profiled kernels of a K9 call, are those of the form
    `flash_fwd_geometry` names, the merge only where there is more than one
    split; a second call on the same input gives the same bits (no
    atomics; the splits are merged in a fixed order). Returns the check's
    text."""
    b, h, sq, dh = q.shape
    sk = k.shape[2]
    geo = _kernels.flash_fwd_geometry(q.dtype, dh, sq, sk, b, h)
    names = FLASH_KERNELS[geo.form][:1 if geo.splits == 1 else None]
    ran = {n for n in names if any(n in e for e in events)}
    if ran != set(names) or len(events) != len(names):
        raise AssertionError(f"fused_attention_fwd B={b} Sq={sq} Sk={sk}: the "
                             f"{geo.form} form (splits {geo.splits}) should "
                             f"run {names}, the profiler saw {sorted(events)}")
    again = kernel()
    torch.cuda.synchronize()
    if not _same_bits(got, again):
        raise AssertionError(f"fused_attention_fwd B={b} Sq={sq} Sk={sk}: two "
                             f"runs on one input differ")
    if geo.form == "many_queries":
        before = K9_I2T_BEFORE_MS.get((b, sq)) if q.dtype == torch.bfloat16 \
            and sk == 15 else None
        before = "" if before is None else \
            f", before the ring form {before:.4f} ms"
        return (f"; {geo.form}, {geo.run} rows a block, {geo.splits} splits, "
                f"{geo.stages} stages, bitwise equal twice{before}")
    if not geo.form.startswith("few_queries"):
        return f"; {geo.form}, bitwise equal twice"
    return (f"; {geo.form}, run {geo.run}, {geo.splits} splits, {geo.stages} "
            f"stages, bitwise equal twice")


def phase_flash(results: dict) -> None:
    """K9 against `flash_attention_reference` at FLASH_CASES; the times of
    FLASH_MAIN_CASE go into `results`."""
    name = "fused_attention_fwd"
    gen = torch.Generator(device="cuda").manual_seed(2)
    for dtype in (torch.bfloat16, torch.float32):
        for label, b, h, sq, sk, dh, layout, masked in FLASH_CASES:
            scale = dh ** -0.5
            q, k, v, bias = _flash_inputs(gen, dtype, b, h, sq, sk, dh, layout,
                                          masked)
            flash.contiguous_copies.update(q=0, k=0, v=0, bias=0)
            kernel = lambda: flash.flash_attention(q, k, v, scale=scale, bias=bias)
            got = kernel()
            torch.cuda.synchronize()
            if any(flash.contiguous_copies.values()):
                raise AssertionError(f"{name} {label}: inputs were copied: "
                                     f"{flash.contiguous_copies}")
            ref = flash.flash_attention_reference(
                q.float(), k.float(), v.float(), scale=scale, bias=bias)
            if not torch.isfinite(got).all():
                raise AssertionError(f"{name} {label}: non-finite output")
            err = (got.float() - ref).abs().max().item()
            rel = err / ref.abs().max().item()
            if not rel <= FLASH_TOL[dtype]:
                raise AssertionError(f"{name} {dtype} {label} B={b} Sq={sq} "
                                     f"Sk={sk}: error {rel} of max |reference| "
                                     f"> {FLASH_TOL[dtype]}")
            if masked:  # batch row 0: uniform over its keys
                uniform = v[0].float().mean(dim=-2, keepdim=True)
                uerr = ((got[0].float() - uniform).abs().max()
                        / uniform.abs().max()).item()
                if not uerr <= FLASH_TOL[dtype]:
                    raise AssertionError(f"{name} {label}: a fully masked row "
                                         f"is not uniform: {uerr}")
            qc, kc, vc = q.contiguous(), k.contiguous(), v.contiguous()
            lib_mask = None if bias is None else bias.to(dtype)
            events = _device_events(kernel)
            ms = sum(events.values())
            own_ms = sum(t for key, t in events.items() if "fused" in key)
            check = _check_flash_launches(q, k, got, events, kernel)
            window_ms, host_ms = _window_ms(kernel)
            plain_ms = _time_ms(lambda: attend_plain(q, k, v, scale=scale, bias=bias))
            lib_ms = _time_ms(lambda: F.scaled_dot_product_attention(
                qc, kc, vc, attn_mask=lib_mask, scale=scale))
            least, by = flash_bound_ms(dtype, b, h, sq, sk, dh, bool(masked))
            tag = f"{str(dtype).split('.')[-1]} {label} B={b} Sq={sq} Sk={sk} Dh={dh}"
            print(f"[3 kernels] {name:22s} {tag:42s} err={err:.3e} (rel "
                  f"{rel:.2e}, tol {FLASH_TOL[dtype]:.0e})  kernel {ms:.4f} ms  plain "
                  f"{plain_ms:.4f} ms  library {lib_ms:.4f} ms  bound "
                  f"{least:.4f} ms ({by})  [device events {len(events)}, K9's own "
                  f"{own_ms:.4f} ms; an event window {window_ms:.4f} ms and the "
                  f"host {host_ms:.4f} ms a call{check}]", flush=True)
            r = results[name]
            r["max_abs_err"] = max(r["max_abs_err"], err)
            if (dtype, label, b, sq) == FLASH_MAIN_CASE:
                r.update(ms=ms, plain_ms=plain_ms, library_ms=lib_ms,
                         bound_ms=least, bound_by=by, shape=tag)
            if (dtype, label, b, sq, sk) in FLASH_TASKQA_CASES:
                r.setdefault("f32_taskqa", {})[f"{label} Sq={sq} Sk={sk}"] = dict(
                    ms=ms, plain_ms=plain_ms, library_ms=lib_ms,
                    bound_ms=least, bound_by=by)
            del q, k, v, qc, kc, vc, got, ref
            torch.cuda.empty_cache()


def _general_qkv(gen, layout: str, dtype, b: int, s: int, h: int, dh: int):
    """qkv [B, S, 3, H, Dh]: the packed projection, or a permuted view of a
    [3, B, H, S, Dh] tensor."""
    if layout == "packed":
        return torch.randn((b, s, 3, h, dh), generator=gen,
                           device="cuda").to(dtype)
    return torch.randn((3, b, h, s, dh), generator=gen,
                       device="cuda").to(dtype).permute(1, 3, 0, 2, 4)


def _dense_mask(axis: str, frames: int, n: int, dtype) -> torch.Tensor:
    """The [S, S] additive mask of `_mask_bias`: 0 where the query is the
    CLS row, the key is the CLS key or the two share a group, -1e9
    elsewhere. For the library call only: the kernels take the mask from
    indices."""
    live = live_mask(1 + frames * n, frames, axis, "cuda")
    return torch.zeros(live.shape, dtype=dtype,
                       device="cuda").masked_fill(~live, -1e9)


def _same_bits(a: torch.Tensor, b: torch.Tensor) -> bool:
    ints = {torch.bfloat16: torch.int16, torch.float32: torch.int32}
    return torch.equal(a.view(ints[a.dtype]), b.view(ints[b.dtype]))


def phase_general(results: dict) -> None:
    """K10 and K11 against the plain version, on the same values in f32, at
    GENERAL_CASES; the times of GENERAL_MAIN_CASE go into `results`. K11
    takes its output and lse from a K10 call, as the autograd Function
    does. Library: one `scaled_dot_product_attention` call with the dense
    additive mask (and its autograd backward), timed only."""
    gen = torch.Generator(device="cuda").manual_seed(3)
    for label, layout, dtype, axis, b, frames, n, h, dh in GENERAL_CASES:
        s = 1 + frames * n
        scale = dh ** -0.5
        kw = dict(scale=scale, axis=axis, num_frames=frames)
        key = (label, layout, dtype, axis)
        qkv = _general_qkv(gen, layout, dtype, b, s, h, dh)
        g = torch.randn((b, s, h, dh), generator=gen, device="cuda").to(dtype)
        out, out_again = (torch.full((b, s, h, dh), float("nan"), dtype=dtype,
                                     device="cuda") for _ in range(2))
        lse, lse_again = (torch.full((b, h, s), float("nan"), device="cuda")
                          for _ in range(2))
        # qkv's strides
        dqkv, dqkv_again = (torch.full_like(qkv, float("nan"))
                            for _ in range(2))
        runs = {
            "divided_attention_general_fwd": lambda: (
                _kernels.divided_attention_general_fwd(qkv, out, lse, **kw)),
            "divided_attention_general_bwd": lambda: (
                _kernels.divided_attention_general_bwd(qkv, out, lse, g, dqkv,
                                                       **kw)),
        }
        for kernel in runs.values():
            kernel()
        # each again on the same input: no atomics, so the same bits
        _kernels.divided_attention_general_fwd(qkv, out_again, lse_again, **kw)
        _kernels.divided_attention_general_bwd(qkv, out, lse, g, dqkv_again,
                                               **kw)
        torch.cuda.synchronize()
        for what, x, y in (("K10", out, out_again), ("K10 lse", lse, lse_again),
                           ("K11", dqkv, dqkv_again)):
            if not _same_bits(x, y):
                raise AssertionError(f"{what} {label} {axis} {layout}: two "
                                     f"runs on one input differ")
        ref = divided_attention_reference(qkv.float(), **kw)
        lse_ref = row_lse_reference(qkv, **kw)
        dref = divided_attention_backward_reference(qkv.float(), g.float(),
                                                    **kw)
        if not (torch.isfinite(out).all() and torch.isfinite(dqkv).all()):
            raise AssertionError(f"K10/K11 {label}: non-finite output")
        fwd_err = (out.float() - ref).abs().max().item()
        fwd_rel = fwd_err / ref.abs().max().item()
        lse_rel = ((lse - lse_ref).abs().max() / lse_ref.abs().max()).item()
        bwd_err, rel_cls, rel = _rel_errs(dqkv, dref)
        checks = {"divided_attention_general_fwd": (
                      fwd_err, fwd_rel, f"rel {fwd_rel:.2e}, lse rel "
                      f"{lse_rel:.2e} (tol {GENERAL_LSE_TOL:.0e})"),
                  "divided_attention_general_bwd": (
                      bwd_err, max(rel_cls, rel),
                      f"rel cls row {rel_cls:.2e} patch rows {rel:.2e}")}
        tag = (f"{str(dtype).split('.')[-1]} {axis} {layout} B={b} S={s} "
               f"H={h} Dh={dh} ({label})")
        for name, (err, worst, check) in checks.items():
            if not worst <= GENERAL_TOL[dtype]:
                raise AssertionError(f"{name} {tag}: error {worst} of max "
                                     f"|reference| > {GENERAL_TOL[dtype]}")
        if not lse_rel <= GENERAL_LSE_TOL:
            raise AssertionError(f"K10 lse {tag}: error {lse_rel} of max "
                                 f"|reference| > {GENERAL_LSE_TOL}")
        # the plain versions as timed: in the input dtype
        q, k, v = (t.contiguous() for t in qkv.permute(2, 0, 3, 1, 4).unbind(0))
        mask = _dense_mask(axis, frames, n, dtype)
        leaves = [t.detach().requires_grad_(True) for t in (q, k, v)]
        lib_out = F.scaled_dot_product_attention(*leaves, attn_mask=mask,
                                                 scale=scale)
        cot = g.transpose(1, 2).contiguous()
        plain = {
            "divided_attention_general_fwd": (
                lambda: divided_attention_reference(qkv, **kw),
                lambda: F.scaled_dot_product_attention(q, k, v, attn_mask=mask,
                                                       scale=scale)),
            "divided_attention_general_bwd": (
                lambda: divided_attention_backward_reference(qkv, g, **kw),
                lambda: torch.autograd.grad(lib_out, leaves, cot,
                                            retain_graph=True)),
        }
        before_ms = {"divided_attention_general_fwd": K10_BEFORE_MS[key],
                     "divided_attention_general_bwd": K11_BEFORE_MS[key]}
        for name, kernel in runs.items():
            err, _, check = checks[name]
            ms = _time_ms(kernel)
            plain_ms, lib_ms = (_time_ms(fn) for fn in plain[name])
            least, by = general_bound_ms(name, dtype, b, frames, n, h, dh,
                                         axis)
            print(f"[3 kernels] {name:30s} {tag:58s} err={err:.3e} ({check}, "
                  f"tol {GENERAL_TOL[dtype]:.0e})  kernel {ms:.4f} ms (before "
                  f"the tiles: {before_ms[name]:.4f} ms; bitwise equal twice)"
                  f"  plain {plain_ms:.4f} ms  library {lib_ms:.4f} ms  bound "
                  f"{least:.4f} ms ({by})", flush=True)
            r = results[name]
            r["max_abs_err"] = max(r["max_abs_err"], err)
            if key == GENERAL_MAIN_CASE:
                r.update(ms=ms, plain_ms=plain_ms, library_ms=lib_ms,
                         bound_ms=least, bound_by=by, shape=tag)
        del qkv, g, out, out_again, lse, lse_again, dqkv, dqkv_again, ref
        del lse_ref, dref, q, k, v, mask, leaves, lib_out
        torch.cuda.empty_cache()


_TINY_SETS = [
        "model.video.img_size=64", "model.video.embed_dim=128",
        "model.video.depth=4", "model.video.num_heads=2",
        "model.video.num_frames=4", "model.text.vocab_size=1000",
        "model.text.hidden_size=128", "model.text.num_layers=4",
        "model.text.num_heads=2", "model.text.intermediate_size=256",
        "model.text.max_position_embeddings=40",
        "model.text.hidden_dropout=0.0", "model.text.attn_dropout=0.0",
        "model.fusion.num_fuse_block=2", "model.fusion.dim_video=128",
        "model.fusion.dim_text=128", "model.fusion.hidden_size=128",
        "model.projection_dim=64", "model.remat=false", "path_remat=false",
]


def _tiny_config():
    return load_train_config(None, _TINY_SETS)


def phase_tiny() -> None:
    cfg = _tiny_config()
    cpu_model = random_init_(EgoVLPv2(cfg.model, device="cpu"),
                             torch.Generator().manual_seed(1))
    gpu_model = EgoVLPv2(cfg.model, device="cuda")
    gpu_model.load_state_dict(cpu_model.state_dict(), strict=True)
    models = (("cpu", cpu_model), ("cuda", gpu_model))

    # inference: the EgoMCQ step
    rng = np.random.default_rng(2)
    video5 = rng.standard_normal((2, 5, 4, 64, 64, 3)).astype(np.float32)
    ids = rng.integers(3, 1000, (2, 15))
    ids[:, 0], ids[0, 9:] = 0, 1  # BOS; padding in item 0
    mask = (ids != 1).astype(np.int64)
    outs = {}
    _reset_counts()
    for dev, model in models:
        o = make_egomcq_eval_step(model.eval())(video5, ids, mask)
        outs[dev] = {k: v.cpu() for k, v in o.items()}
    errs = {k: (outs["cuda"][k] - outs["cpu"][k]).abs().max().item()
            for k in ("vtc", "vtm")}
    print(f"[4 tiny] egomcq cuda vs cpu max_abs_err {errs} (tol 1e-3)",
          flush=True)
    if not all(e <= 1e-3 for e in errs.values()):
        raise AssertionError(f"tiny model: cuda and cpu disagree: {errs}")

    # training: one step's losses and gradients, the same mined indices
    batch = synthetic_batch(cfg, 6, np.random.default_rng(3))
    mined = ITMIndices(torch.tensor([0, 3, 2, 5, 4, 1]),
                       torch.tensor([0, 1, 2, 3, 0, 5]),
                       torch.tensor([1, 0, 1, 0, 0, 0]))
    mine = train_step_module.mine_itm_indices
    losses, grads = {}, {}
    try:
        for dev, model in models:
            train_step_module.mine_itm_indices = lambda *a, dev=dev, **k: \
                ITMIndices(*(t.to(dev) for t in mined))
            model.train().zero_grad(set_to_none=True)
            loss, metrics = train_step_module.pretrain_loss_fn(
                model, train_step_module.batch_to_device(batch, torch.device(dev)),
                None, cfg=cfg)
            loss.backward()
            losses[dev] = {k: v.item() for k, v in metrics.items()}
            grads[dev] = {n: p.grad.cpu() for n, p in model.named_parameters()}
    finally:
        train_step_module.mine_itm_indices = mine
    _compare_tiny_steps("pretrain step", losses, grads)
    _check_f32_launches("tiny model", {}, dict(_kernels.launch_counts))

    # the dual fine-tune step, without and with one checkpoint region a block
    rng = np.random.default_rng(4)
    dual_batch = {"video": rng.standard_normal((6, 4, 64, 64, 3)).astype(np.float32),
                  "text_ids": rng.integers(3, 1000, (6, 15)),
                  "text_mask": np.ones((6, 15), np.int64)}
    dual_batch["text_ids"][:, 0] = 0
    dual_batch["text_ids"][0, 9:], dual_batch["text_mask"][0, 9:] = 1, 0
    for remat in (False, True):
        dual_cfg = dataclasses.replace(
            cfg, model=dataclasses.replace(
                cfg.model, projection="small", with_itm_head=False,
                with_mlm_head=False, remat=remat),
            loss=dataclasses.replace(cfg.loss, type="NormSoftmax"))
        cpu_dual = random_init_(EgoVLPv2(dual_cfg.model, device="cpu"),
                                torch.Generator().manual_seed(5))
        gpu_dual = EgoVLPv2(dual_cfg.model, device="cuda")
        gpu_dual.load_state_dict(cpu_dual.state_dict(), strict=True)
        losses, grads = {}, {}
        before = dict(_kernels.launch_counts)
        for dev, model in (("cpu", cpu_dual), ("cuda", gpu_dual)):
            model.train()
            loss, metrics = dual_loss_fn(
                model, train_step_module.batch_to_device(dual_batch, torch.device(dev)),
                cfg=dual_cfg)
            loss.backward()
            losses[dev] = {k: v.item() for k, v in metrics.items()}
            grads[dev] = {n: p.grad.cpu() for n, p in model.named_parameters()
                          if p.grad is not None}
        if set(grads["cpu"]) != set(grads["cuda"]):
            raise AssertionError("tiny dual step: other parameters have gradients")
        _compare_tiny_steps(f"dual step, remat {remat}", losses, grads)
        _check_f32_launches(f"tiny dual step, remat {remat}", before,
                            dict(_kernels.launch_counts))


def phase_tiny_extract() -> None:
    """The extractors' outputs on the card within 1e-3 of max |cpu output|,
    from one seeded model at 4 frames (MQ, NLQ) and one at 5 (QFVS)."""
    tok = Tokenizer("roberta-base", max_len=15, vocab_cap=1000)
    enc = tok(list(NLQ_QUERIES))
    rng = np.random.default_rng(6)
    frames = rng.integers(0, 256, (23, 64, 64, 3), dtype=np.uint8)

    def pair(cfg, seed):
        cpu = random_init_(EgoVLPv2(cfg.model, device="cpu"),
                           torch.Generator().manual_seed(seed))
        gpu = EgoVLPv2(cfg.model, device="cuda")
        gpu.load_state_dict(cpu.state_dict(), strict=True)
        return {"cpu": cpu, "cuda": gpu}

    outs, change_points = {}, {}
    for dev, model in pair(_tiny_config(), 7).items():
        ex = FeatureExtractor(model, inner_batch=4, device_norm="imagenet")
        outs[dev] = {
            "mq features": ex.clip_features(frames, 4),
            "nlq fused features": ex.fused_window_features(
                frames, 4, enc["text_ids"][0], enc["text_mask"][0]),
            "nlq query tokens": ex.text_tokens(enc["text_ids"], enc["text_mask"]),
        }
    qcfg = load_train_config(None, [
        *(s for s in _TINY_SETS if "num_frames" not in s),
        "model.video.num_frames=5"])
    scenes = frames.astype(np.float32) / 255.0
    scenes[10:] *= 0.1  # a cut to a dark scene after two clips: a change point
    for dev, model in pair(qcfg, 8).items():
        res = QFVSExtractor(model, inner_batch=2).extract_video(
            scenes, tok, QFVS_CONCEPTS, QFVS_ORACLE, max_segments=4)
        change_points[dev] = res["change_points"].tolist()
        outs[dev].update({f"qfvs features '{k}'": v
                          for k, v in res["features"].items()})
    errs = {}
    for key, ref in outs["cpu"].items():
        got = outs["cuda"][key]
        if got.shape != ref.shape or not np.isfinite(got).all():
            raise AssertionError(f"tiny extract: {key}: bad output on cuda")
        errs[key] = float(np.abs(got - ref).max() / max(np.abs(ref).max(), 1e-30))
    print(f"[4 tiny] extract cuda vs cpu, error of max |cpu output| "
          f"{ {k: f'{e:.2e}' for k, e in errs.items()} } (tol 1e-3); qfvs "
          f"change points {change_points}; K9 inputs copied "
          f"{flash.contiguous_copies}", flush=True)
    if not all(e <= 1e-3 for e in errs.values()) or not change_points["cpu"] \
            or change_points["cuda"] != change_points["cpu"]:
        raise AssertionError(f"tiny extract: cuda and cpu disagree: {errs}, "
                             f"{change_points}")


# The QA model at a head dim of 12 (width 24, 2 heads, video and text): no
# head dim K1-K6 or the tensor-core K9 take.
_TINY_QA_SETS = [*_TINY_SETS, "model.video.embed_dim=24",
                 "model.text.hidden_size=24", "model.text.intermediate_size=48",
                 "model.fusion.dim_video=24", "model.fusion.dim_text=24",
                 "model.fusion.hidden_size=24", "model.projection_dim=16"]


def phase_tiny_qa() -> None:
    """The EgoTaskQA model at a head dim of 12 from one seeded state_dict on
    the card (kernels) and on the CPU (plain), f32, dropout off (eval mode):
    logits and the cross-entropy within 1e-3, every parameter's gradient
    within 1e-3 of max |cpu gradient|; K7-K11 launched, K1-K6 not."""
    cfg = load_train_config(None, _TINY_QA_SETS)
    answers = 7
    cpu = random_init_(make_qa_model(cfg.model, answers, device="cpu"),
                       torch.Generator().manual_seed(9))
    gpu = make_qa_model(cfg.model, answers, device="cuda")
    gpu.load_state_dict(cpu.state_dict(), strict=True)
    batch = default_collate(synthetic_qa_items(
        cfg.model, 4, answers, 15, np.random.default_rng(10)))
    batch.pop("reasoning_types")
    logits, losses, grads = {}, {}, {}
    _reset_counts()
    for dev, model in (("cpu", cpu), ("cuda", gpu)):
        model.eval().zero_grad(set_to_none=True)
        t = train_step_module.batch_to_device(batch, torch.device(dev))
        out = model(t["video"], t["text_ids"], t["text_mask"])
        loss = cross_entropy_loss(out, t["answer"])
        loss.backward()
        logits[dev] = out.detach().cpu()
        losses[dev] = {"loss": loss.item()}
        grads[dev] = {n: p.grad.cpu() for n, p in model.named_parameters()
                      if p.grad is not None}
    err = (logits["cuda"] - logits["cpu"]).abs().max().item()
    print(f"[4 tiny] qa model Dh=12 cuda vs cpu: logits {tuple(logits['cpu'].shape)}"
          f" max_abs_err {err:.2e} (tol 1e-3)", flush=True)
    if not err <= 1e-3 or set(grads["cpu"]) != set(grads["cuda"]):
        raise AssertionError(f"tiny qa model: cuda and cpu disagree: logits "
                             f"{err}, or other parameters have gradients")
    _compare_tiny_steps("qa model Dh=12", losses, grads)
    _check_f32_launches("tiny qa model", {}, dict(_kernels.launch_counts))


def _check_f32_launches(what: str, before: dict, after: dict) -> None:
    """A float32 model on the card: K7-K11 launched since `before` (empty:
    since 0), and none of K1-K6, which the dispatch keeps for bf16."""
    ran = {k: after[k] - before.get(k, 0) for k in after}
    if not all(ran[k] for k in KERNELS if k not in GROUPED_KERNELS) \
            or any(ran[k] for k in GROUPED_KERNELS):
        raise AssertionError(f"{what}: launches {ran}: float32 takes K7-K11 "
                             f"and none of K1-K6")


def _compare_tiny_steps(what: str, losses: dict, grads: dict) -> None:
    """cuda against cpu: loss parts within 1e-3, every gradient within 1e-3
    of max |cpu gradient| of its tensor."""
    loss_err = max(abs(losses["cuda"][k] - losses["cpu"][k]) for k in losses["cpu"])
    worst, worst_name = 0.0, ""
    for name, ref in grads["cpu"].items():
        rel = ((grads["cuda"][name] - ref).abs().max()
               / ref.abs().max().clamp_min(1e-6)).item()
        if rel > worst:
            worst, worst_name = rel, name
    print(f"[4 tiny] {what} cuda vs cpu: losses {losses['cuda']} max_abs_err "
          f"{loss_err:.2e} (tol 1e-3); {len(grads['cpu'])} parameter gradients, "
          f"worst {worst:.2e} of max |cpu gradient| at {worst_name} (tol 1e-3); "
          f"launches so far {dict(_kernels.launch_counts)}", flush=True)
    if not (loss_err <= 1e-3 and worst <= 1e-3):
        raise AssertionError(f"tiny model, {what}: cuda and cpu disagree")


def _no_flash_copies(path: str) -> None:
    if any(flash.contiguous_copies.values()):
        raise AssertionError(f"{path}: K9 inputs were copied to make them "
                             f"readable by stride: {flash.contiguous_copies}")


def phase_egomcq() -> dict:
    """Returns path -> the launch counts of that path's own run."""
    base = ["egomcq", "--config", "configs/eval_egomcq.json", "--device",
            "cuda", "--val_batches", "2"]
    by_path = {}
    # one question at a time (5 candidates): B * H = 60 under FLASH_BLOCKS,
    # so K9's t2i calls split the keys and merge (3 runs of 1152 keys)
    for label, extra in (("16f", []),
                         ("4f", ["--set", "model.video.num_frames=4"]),
                         ("16f_1q", ["--batch_size", "1"])):
        _reset_counts()
        res = cli.main(base + extra)
        counts = dict(_kernels.launch_counts)
        scores = res["scores"]
        finite = all(np.isfinite(v).all() for v in scores.values())
        steps_ms = [round(x * 1e3, 1) for x in res["step_seconds"]]
        step_s = res["step_seconds"][-1]  # the first step carries warm-up
        shapes = {k: v.shape for k, v in scores.items()}
        print(f"[5 slices] egomcq {label}: metrics {res['metrics']} | step "
              f"{step_s * 1e3:.1f} ms (one sample: the last of steps "
              f"{steps_ms} ms, input copy included) | "
              f"{res['clips_per_step'] / step_s:.2f} clips/s | scores "
              f"{shapes} finite={finite} | launches {counts}, K7 by rows "
              f"{_k7_rows()} | LayerNorm inputs "
              f"copied to make them contiguous {ln.contiguous_copies}, K9 "
              f"inputs {flash.contiguous_copies}", flush=True)
        _no_flash_copies(f"egomcq {label}")
        if not finite or set(scores) != {"vtc", "vtm"}:
            raise AssertionError(f"egomcq {label}: bad scores {scores}")
        if not all(counts[k] for k in BF16_PATH_KERNELS if k.endswith("_fwd")) \
                or any(counts[k] for k in GENERAL_KERNELS):
            raise AssertionError(f"egomcq {label}: a kernel was not launched, "
                                 f"or K10/K11 was: {counts}")
        if label == "16f_1q" and _kernels.flash_fwd_geometry(
                torch.bfloat16, DH, 15, 3137, 5, H).splits < 2:
            raise AssertionError("egomcq 16f_1q: K9's t2i does not split")
        by_path[f"egomcq_{label}"] = counts
        del res
        _free()
    return by_path


def _ln_rows_a_step(steps: int, counts=None) -> dict:
    """K8's launches a step since the last reset, by the rows of x (a
    training path runs the LayerNorm backward in its steps alone), or those
    of `counts` (`_kernels.layernorm_fwd_rows`: K7's)."""
    counts = _kernels.layernorm_bwd_rows if counts is None else counts
    return {rows: n / steps for rows, n in sorted(counts.items())}


def _k7_rows() -> dict:
    """K7's launches since the last reset, by the rows of x."""
    return dict(sorted(_kernels.layernorm_fwd_rows.items()))


def phase_pretrain() -> dict:
    args = ["pretrain", "--synthetic", "--device", "cuda", "--steps_per_epoch",
            str(PRETRAIN_STEPS), "--set", *PRETRAIN_SETS]
    torch.cuda.reset_peak_memory_stats()
    _reset_counts()
    mark = SPANS.last
    with _witnessed(pretrain_task, "build_pretrain",
                    (1, PRETRAIN_STEPS)) as seen:
        res = cli.main(args)
    counts = dict(_kernels.launch_counts)
    peak = torch.cuda.max_memory_allocated()
    kinds = _step_kinds(mark)
    python = _python_steps(kinds)
    rows = res["logged"]
    if len(rows) != PRETRAIN_STEPS or len(kinds) != PRETRAIN_STEPS:
        raise AssertionError(f"pretrain logged {len(rows)} steps, ran "
                             f"{kinds}")
    for row in rows:
        if not all(np.isfinite(v) for v in row.values()):
            raise AssertionError(f"pretrain: non-finite loss part in {row}")
    # remat off, one card, no group: the step replays as one CUDA graph
    if kinds[-1] != "replay":
        raise AssertionError(f"pretrain: steps ran {kinds}")
    _check_witness("pretrain", seen, 1, PRETRAIN_STEPS)
    per_step = {k: v / python for k, v in counts.items()}
    if not all(per_step[k] >= 1 and per_step[k] == int(per_step[k])
               for k in BF16_PATH_KERNELS) \
            or any(counts[k] for k in GENERAL_KERNELS):
        raise AssertionError(f"pretrain: launches a step {per_step}")
    cfg = load_train_config(None, PRETRAIN_SETS)
    fresh = training_init_(EgoVLPv2(cfg.model, device="cpu"),
                           torch.Generator().manual_seed(cfg.seed))
    moved = sum(not torch.equal(p.detach().cpu(), q.detach())
                for p, q in zip(res["model"].parameters(), fresh.parameters()))
    n_params = sum(1 for _ in fresh.parameters())
    steps_ms = [s * 1e3 for s in res["step_seconds"]]
    warm = float(np.median(steps_ms[2:]))  # the first two carry warm-up
    print(f"[5 slices] pretrain b16 4f bf16: {PRETRAIN_STEPS} steps, last "
          f"{rows[-1]} | step ms (from next(): the synthetic batch's host "
          f"RNG included) {[round(x, 1) for x in steps_ms]}, median of "
          f"the last {PRETRAIN_STEPS - 2} {warm:.1f} ms = "
          f"{res['clips_per_step'] / warm * 1e3:.2f} clips/s (steps 1 and "
          f"{PRETRAIN_STEPS} profiled) | steps ran {kinds} | launches a "
          f"step, over the {python} whose wrappers ran {per_step} | hand "
          f"kernels on the device, step 1 (eager) {seen[1][1]}, step "
          f"{PRETRAIN_STEPS} ({seen[PRETRAIN_STEPS][0][0]}) the same | K7 "
          f"launches a step by rows "
          f"{_ln_rows_a_step(python, _kernels.layernorm_fwd_rows)} | "
          f"K8 launches a step by rows "
          f"{_ln_rows_a_step(python)} | LayerNorm inputs copied to "
          f"make them contiguous {ln.contiguous_copies}, K9 inputs "
          f"{flash.contiguous_copies} | parameters changed {moved}/{n_params} | "
          f"peak memory {peak / 2**30:.2f} GiB (a graph's pool not in it)",
          flush=True)
    _no_flash_copies("pretrain")
    if moved < n_params // 2:
        raise AssertionError(f"pretrain: only {moved}/{n_params} parameters "
                             "changed")
    single = {"rows": rows, "step_ms": steps_ms, "peak": peak,
              "python_steps": python}
    del res
    _free()
    return counts, single


def phase_finetune() -> dict:
    """The 32-frame Charades-Ego fine-tune through `cli ft-charades`, first
    without rematerialisation, then with one checkpoint region a block.
    Returns run -> the launch counts of that run."""
    by_run = {}
    for label, remat_set, steps in FINETUNE_RUNS:
        args = ["ft-charades", "--synthetic", "--device", "cuda", "--config",
                FINETUNE_CONFIG, "--steps_per_epoch", str(steps), "--set",
                *FINETUNE_SETS, remat_set]
        torch.cuda.reset_peak_memory_stats()
        _reset_counts()
        mark = SPANS.last
        with _witnessed(retrieval_task, "build_dual", (1, steps)) as seen:
            res = cli.main(args)
        counts = dict(_kernels.launch_counts)
        peak = torch.cuda.max_memory_allocated()
        kinds = _step_kinds(mark)
        python = _python_steps(kinds)
        rows, cfg = res["logged"], res["config"]
        if len(rows) != steps or len(kinds) != steps:
            raise AssertionError(f"{label} logged {len(rows)} steps, ran "
                                 f"{kinds}")
        if not all(np.isfinite(row["loss_total"]) for row in rows):
            raise AssertionError(f"{label}: non-finite loss in {rows}")
        # the steps replay as one CUDA graph without checkpoint regions
        if (kinds[-1] == "replay") == cfg.model.remat:
            raise AssertionError(f"{label}: steps ran {kinds}")
        _check_witness(label, seen, 1, steps)
        per_step = {k: v / python for k, v in counts.items()}
        if not all(per_step[k] >= 1 and per_step[k] == int(per_step[k])
                   for k in FINETUNE_KERNELS) \
                or any(counts[k] for k in GENERAL_KERNELS):
            raise AssertionError(f"{label}: launches a step {per_step}")
        fresh = training_init_(EgoVLPv2(cfg.model, device="cpu"),
                               torch.Generator().manual_seed(cfg.seed))
        moved = sum(not torch.equal(p.detach().cpu(), q.detach())
                    for p, q in zip(res["model"].parameters(), fresh.parameters()))
        n_params = sum(1 for _ in fresh.parameters())
        steps_ms = [s * 1e3 for s in res["step_seconds"]]
        warm = float(np.median(steps_ms[2:])) if steps > 2 else steps_ms[-1]
        v = cfg.model.video
        print(f"[5 slices] {label} b{cfg.global_batch_size} {v.num_frames}f "
              f"S={v.seq_len} {cfg.model.compute_dtype} {remat_set}: {steps} "
              f"steps, losses {[round(r['loss_total'], 4) for r in rows]} | step "
              f"ms (from next(): the synthetic batch's host RNG included) "
              f"{[round(x, 1) for x in steps_ms]}, "
              f"{'median of the last ' + str(steps - 2) if steps > 2 else 'the last'}"
              f" {warm:.1f} ms = {res['clips_per_step'] / warm * 1e3:.2f} "
              f"clips/s (steps 1 and {steps} profiled) | steps ran {kinds} | "
              f"launches a step, over the {python} whose wrappers ran "
              f"{per_step} | hand kernels on the device, step 1 and step "
              f"{steps} each {seen[1][1]} | K7 launches a step by "
              f"rows {_ln_rows_a_step(python, _kernels.layernorm_fwd_rows)} | "
              f"K8 launches a step by "
              f"rows {_ln_rows_a_step(python)} | LayerNorm inputs copied "
              f"to make them contiguous {ln.contiguous_copies} | parameters "
              f"changed {moved}/{n_params} | peak memory {peak / 2**30:.2f} GiB",
              flush=True)
        if moved < n_params // 2:
            raise AssertionError(f"{label}: only {moved}/{n_params} parameters "
                                 "changed")
        by_run[label] = counts
        del res, fresh
        _free()
    return by_run


def _batch_ms(log) -> str:
    ms = [m for _, m in log]
    return (f"inner batches {log[0][0]} ms {[round(m, 1) for m in ms]}, "
            f"{sum(ms):.1f} ms in all")


def _check_extract(path: str, counts: dict, fused: bool) -> None:
    need = ["space_attention_fwd", "time_attention_fwd",
            "cls_row_attention_fwd", "layernorm_fwd"]
    if fused:
        need.append("fused_attention_fwd")
    if not all(counts[k] for k in need) \
            or any(counts[k] for k in GENERAL_KERNELS):
        raise AssertionError(f"{path}: a kernel was not launched, or K10/K11 "
                             f"was: {counts}")
    _no_flash_copies(path)


def phase_extract() -> dict:
    """The three feature-extraction paths at full width, bf16. Returns path
    -> the launch counts of that path's own run."""
    by_path = {}
    cfg = load_train_config(EXTRACT_CONFIG, [])
    v = cfg.model.video
    with tempfile.TemporaryDirectory() as out:
        # MQ: the dual video tower through `cli extract`
        _reset_counts()
        res = cli.main(["extract", "--config", EXTRACT_CONFIG, "--device",
                        "cuda", "--synthetic", str(EXTRACT_FRAMES), "--out", out])
        counts = dict(_kernels.launch_counts)
        feats = res["features"]["synthetic"]
        n_win = EXTRACT_FRAMES // v.num_frames
        ok = feats.shape == (n_win, cfg.model.projection_dim) \
            and np.isfinite(feats).all() and feats.std() > 0 \
            and np.array_equal(np.load(os.path.join(out, "synthetic.npy")), feats)
        print(f"[5 slices] extract mq {v.num_frames}f S={v.seq_len} "
              f"{cfg.model.compute_dtype}: {EXTRACT_FRAMES} uint8 frames -> "
              f"features {feats.shape} ok={ok} | "
              f"{_batch_ms(res['inner_batches'])} | launches {counts}, K7 by "
              f"rows {_k7_rows()}", flush=True)
        if not ok or len(res["inner_batches"]) != 2:
            raise AssertionError("extract mq: bad features or inner batches")
        _check_extract("extract mq", counts, fused=False)
        by_path["extract_mq"] = counts

        # NLQ: the fused stack, two queries over the same frames
        model = res["model"]
        frames = np.random.default_rng(cfg.seed).integers(
            0, 256, (EXTRACT_FRAMES, v.img_size, v.img_size, v.in_chans),
            dtype=np.uint8)
        tok = Tokenizer("roberta-base", max_len=cfg.max_text_len,
                        vocab_cap=cfg.model.text.vocab_size)
        records = [{"clip_uid": "synthetic", "annotation_uid": "a0",
                    "query_idx": i, "query": q}
                   for i, q in enumerate(NLQ_QUERIES)]
        ex = FeatureExtractor(model, inner_batch=64, device_norm="imagenet")
        _reset_counts()
        n_windows = extract_nlq_features(ex, tok, records, lambda uid: frames,
                                         v.num_frames, out)
        counts = dict(_kernels.launch_counts)
        shapes = {}
        for i in range(len(NLQ_QUERIES)):
            for suffix, shape in (("", (n_win, v.embed_dim)),
                                  ("_query", (cfg.max_text_len,
                                              cfg.model.text.hidden_size))):
                arr = np.load(os.path.join(out, f"synthetic_a0_{i}{suffix}.npy"))
                shapes[f"q{i}{suffix}"] = arr.shape
                if arr.shape != shape or not np.isfinite(arr).all() \
                        or not arr.std() > 0:
                    raise AssertionError(f"extract nlq: bad output q{i}{suffix}"
                                         f" {arr.shape}")
        q0 = np.load(os.path.join(out, "synthetic_a0_0.npy"))
        q1 = np.load(os.path.join(out, "synthetic_a0_1.npy"))
        if n_windows != {"synthetic": n_win} or np.array_equal(q0, q1):
            raise AssertionError("extract nlq: the query does not reach the "
                                 "fused features")
        print(f"[5 slices] extract nlq: {len(NLQ_QUERIES)} queries x {n_win} "
              f"windows -> {shapes} | {_batch_ms(ex.batch_log)} | launches "
              f"{counts}, K7 by rows {_k7_rows()} | K9 inputs copied "
              f"{flash.contiguous_copies}",
              flush=True)
        _check_extract("extract nlq", counts, fused=True)
        by_path["extract_nlq"] = counts
        del res, model, ex, frames
        _free()

    # QFVS: 5 frames a clip, the unfused tower, KTS, the fused blocks a prompt
    qcfg = load_train_config(EXTRACT_CONFIG, ["model.video.num_frames=5"])
    model = EgoVLPv2(qcfg.model, device="cuda").eval()
    random_init_(model, torch.Generator().manual_seed(qcfg.seed))
    frames = np.random.default_rng(qcfg.seed).integers(
        0, 256, (QFVS_FRAMES, v.img_size, v.img_size, v.in_chans), dtype=np.uint8)
    ex = QFVSExtractor(model, inner_batch=QFVS_INNER_BATCH)
    _reset_counts()
    t0 = time.perf_counter()
    res = ex.extract_video(frames, tok, QFVS_CONCEPTS, QFVS_ORACLE)
    total_ms = (time.perf_counter() - t0) * 1e3
    counts = dict(_kernels.launch_counts)
    n_clips = QFVS_FRAMES // 5
    hs = qcfg.model.fusion.hidden_size
    feats = res["features"]
    ok = res["num_shots"] == n_clips \
        and list(feats) == [*QFVS_CONCEPTS, QFVS_ORACLE] \
        and all(f.shape == (n_clips, hs) and np.isfinite(f).all()
                and f.std() > 0 for f in feats.values()) \
        and not np.array_equal(feats[QFVS_CONCEPTS[0]], feats[QFVS_CONCEPTS[1]])
    print(f"[5 slices] extract qfvs 5f S={qcfg.model.video.seq_len}: "
          f"{QFVS_FRAMES} uint8 frames -> {n_clips} clips, change points "
          f"{res['change_points'].tolist()}, features "
          f"{ {k: f.shape for k, f in feats.items()} } ok={ok} | "
          f"{total_ms:.1f} ms in all; {_batch_ms(ex.batch_log)} | launches "
          f"{counts} | K9 inputs copied {flash.contiguous_copies}", flush=True)
    if not ok:
        raise AssertionError("extract qfvs: bad output")
    _check_extract("extract qfvs", counts, fused=True)
    by_path["extract_qfvs"] = counts
    del res, model, ex
    _free()
    return by_path


def phase_taskqa() -> dict:
    """The EgoTaskQA fine-tune through `run_egotaskqa` at full width
    (TimeSformer-B + RoBERTa-base, 6 fused blocks each, the QA head), the
    TrainConfig defaults: 4 frames at 224, S=785, float32, 15 tokens; batch
    8, TASKQA_STEPS steps, then the evaluation over TASKQA_VAL_BATCHES
    batches. Every step: a finite loss, K11 24 launches (12 blocks, two
    axes), K10 as many again where `model.remat` (on in the defaults, as in
    the JAX package) recomputes each block's forward in the backward, K1-K6
    none. Returns the run's launch counts."""
    cfg = load_train_config(None, [])
    items = synthetic_qa_items(
        cfg.model, (TASKQA_STEPS + TASKQA_VAL_BATCHES) * TASKQA_BATCH,
        TASKQA_ANSWERS, cfg.max_text_len, np.random.default_rng(cfg.seed),
        QA_TYPES)
    cut = TASKQA_STEPS * TASKQA_BATCH
    rows, seconds, at_step, forms_at_step = [], [], [], []

    def on_step(step, metrics, sec):
        rows.append(metrics)
        seconds.append(sec)
        at_step.append(dict(_kernels.launch_counts))
        forms_at_step.append(dict(_kernels.flash_form_counts))

    torch.cuda.reset_peak_memory_stats()
    _reset_counts()
    metrics = run_egotaskqa(cfg.model, items[:cut], items[cut:],
                            TASKQA_ANSWERS, reasoning_types=QA_TYPES,
                            epochs=1, batch_size=TASKQA_BATCH, device="cuda",
                            on_step=on_step)
    counts = dict(_kernels.launch_counts)
    forms = dict(_kernels.flash_form_counts)
    peak = torch.cuda.max_memory_allocated()
    per_step = [{k: c[k] - (at_step[i - 1][k] if i else 0) for k in c}
                for i, c in enumerate(at_step)]
    # K9 by form, in a step and in the evaluation (after the last step)
    step_forms = [{k: c[k] - (forms_at_step[i - 1][k] if i else 0) for k in c}
                  for i, c in enumerate(forms_at_step)]
    eval_forms = {k: forms[k] - forms_at_step[-1][k] for k in forms}
    steps_ms = [x * 1e3 for x in seconds]
    warm = float(np.median(steps_ms[2:]))  # the first two carry warm-up
    v = cfg.model.video
    print(f"[5 slices] taskqa b{TASKQA_BATCH} {v.num_frames}f S={v.seq_len} "
          f"{cfg.model.compute_dtype}, {TASKQA_ANSWERS} answers: "
          f"{len(rows)} steps, losses {[round(r['loss_total'], 4) for r in rows]}"
          f" | step ms {[round(x, 1) for x in steps_ms]}, median of the last "
          f"{len(steps_ms) - 2} {warm:.1f} ms = {TASKQA_BATCH / warm * 1e3:.2f}"
          f" clips/s | launches a step { {k: n for k, n in per_step[-1].items() if n} }"
          f" | launches in all (steps and evaluation) "
          f"{ {k: n for k, n in counts.items() if n} } | K9 by form a step "
          f"{ {k: n for k, n in step_forms[-1].items() if n} }, in the "
          f"evaluation { {k: n for k, n in eval_forms.items() if n} } | K7 "
          f"launches in all by rows {_k7_rows()} | K8 "
          f"launches a step by rows {_ln_rows_a_step(TASKQA_STEPS)} | "
          f"evaluation {metrics} | peak memory {peak / 2**30:.2f} GiB",
          flush=True)
    if len(rows) != TASKQA_STEPS \
            or not all(np.isfinite(r["loss_total"]) for r in rows):
        raise AssertionError(f"taskqa: steps {rows}")
    want = {"divided_attention_general_fwd": 24 * (1 + cfg.model.remat),
            "divided_attention_general_bwd": 24}
    for n in per_step:
        if any(n[k] != want[k] for k in GENERAL_KERNELS) \
                or any(n[k] for k in GROUPED_KERNELS):
            raise AssertionError(f"taskqa: launches a step {n}: K10/K11 "
                                 f"{want}, K1-K6 none")
    if not ("acc" in metrics and all(np.isfinite(x) for x in metrics.values())):
        raise AssertionError(f"taskqa: evaluation {metrics}")
    # K9 in f32 takes its 3xTF32 forms: in a training step the i2t of the
    # fused video blocks (again under remat; the text attention drops
    # probabilities), in the evaluation also every text self-attention
    # and the t2i of the fused text layers
    fuse, layers = cfg.model.fusion.num_fuse_block, cfg.model.text.num_layers
    none = dict.fromkeys(forms, 0)
    want_step = {**none, "many_queries_tf32": fuse * (1 + cfg.model.remat)}
    want_eval = {**none, "many_queries_tf32": fuse * TASKQA_VAL_BATCHES,
                 "few_queries_tf32": (layers + fuse) * TASKQA_VAL_BATCHES}
    if any(n != want_step for n in step_forms) or eval_forms != want_eval:
        raise AssertionError(f"taskqa: K9 by form a step {step_forms}, in "
                             f"the evaluation {eval_forms}: want "
                             f"{want_step} and {want_eval}")
    _free()
    return counts


def _overlap_us(events: list, spans: list, bridge_us: float = 0.0) -> float:
    """The µs of `events` (trace events with ts and dur) that lie inside
    the union of `spans` ((start, end) pairs), gaps of up to `bridge_us`
    between spans counted as inside."""
    merged = []
    for lo, hi in sorted(spans):
        if merged and lo <= merged[-1][1] + bridge_us:
            merged[-1][1] = max(merged[-1][1], hi)
        else:
            merged.append([lo, hi])
    return sum(max(0.0, min(e["ts"] + e["dur"], b) - max(e["ts"], a))
               for e in events for a, b in merged)


def _copies_and_overlap(trace_path: str) -> dict:
    """From a torch.profiler trace (chrome JSON): the host-to-device copies
    of at least FEED_COPY_BYTES (a batch's arrays) with their device ms,
    bytes, kinds and streams; the streams the kernels ran on; how many ms
    of those copies lie inside the device's busy periods (kernels at most
    FEED_BUSY_GAP_US apart: the copy runs while the step's work does) and
    how many under a running kernel (less where the host is the bound: its
    small kernels leave the card idle between launches); and the calls
    that allocate or free pinned host memory (they synchronise the
    device)."""
    with open(trace_path) as f:
        events = json.load(f)["traceEvents"]
    kernels = [e for e in events if e.get("cat") == "kernel"]
    copies = [e for e in events if e.get("cat") == "gpu_memcpy"
              and "HtoD" in e.get("name", "")
              and e.get("args", {}).get("bytes", 0) >= FEED_COPY_BYTES]
    compute = {e["args"]["stream"] for e in kernels}
    spans = [(e["ts"], e["ts"] + e["dur"]) for e in kernels]
    host = {}
    for e in events:
        if e.get("name") in ("cudaHostAlloc", "cudaMallocHost",
                             "cudaFreeHost", "cudaHostRegister"):
            host[e["name"]] = host.get(e["name"], 0) + 1
    return {"copies": len(copies),
            "copy_ms": sum(e["dur"] for e in copies) / 1e3,
            "copy_mb": sum(e["args"]["bytes"] for e in copies) / 1e6,
            "copy_streams": sorted({e["args"]["stream"] for e in copies}),
            "copy_kinds": sorted({e["name"] for e in copies}),
            "kernel_streams": sorted(compute),
            "in_busy_ms": _overlap_us(copies, spans, FEED_BUSY_GAP_US) / 1e3,
            "under_kernels_ms": _overlap_us(copies, spans) / 1e3,
            "pinned_alloc_calls": host}


def _feed_run(label: str, build, source, depth: int,
              trace_dir: str = None) -> dict:
    """One run of the feed phase: `build()` -> a fresh seeded train step,
    `source()` -> an iterator of numpy batches, fed through
    `device_prefetch` with the card's put at `depth`: FEED_WARM +
    FEED_TIMED steps through `cli._train_loop` (each timed from its
    `next()` to the end of its device work), then FEED_PROFILED steps under
    torch.profiler (its chrome trace kept gzipped in `trace_dir`, if
    given). Returns the losses, the timed steps' seconds and the profile's
    copies."""
    train_step = build()
    batches = device_prefetch(source(), device_put("cuda"), depth)
    args = argparse.Namespace(epochs=1, log_every=1)
    with contextlib.redirect_stdout(io.StringIO()):  # a JSON line a step
        logged, seconds = cli._train_loop(
            args, torch.device("cuda"), train_step,
            lambda _: itertools.islice(batches, FEED_WARM + FEED_TIMED))
    with tempfile.TemporaryDirectory() as tmp:
        trace = os.path.join(tmp, "feed.json")
        with profile(activities=[ProfilerActivity.CPU,
                                 ProfilerActivity.CUDA]) as prof:
            for batch in itertools.islice(batches, FEED_PROFILED):
                train_step(batch)
            torch.cuda.synchronize()
        prof.export_chrome_trace(trace)
        copies = _copies_and_overlap(trace)
        if trace_dir:
            os.makedirs(trace_dir, exist_ok=True)
            with open(trace, "rb") as f, gzip.open(os.path.join(
                    trace_dir, f"feed_{label}_d{depth}.json.gz"), "wb") as g:
                shutil.copyfileobj(f, g)
    batches.close()
    if len(logged) != FEED_WARM + FEED_TIMED:
        raise AssertionError(f"feed {label} depth {depth}: {len(logged)} "
                             f"steps")
    losses = [{k: v for k, v in r.items() if k.startswith("loss")}
              for r in logged]
    if not all(np.isfinite(v) for r in losses for v in r.values()):
        raise AssertionError(f"feed {label} depth {depth}: losses {losses}")
    if not copies["copies"] or set(copies["copy_streams"]) \
            & set(copies["kernel_streams"]) \
            or any("Pinned" not in k for k in copies["copy_kinds"]):
        raise AssertionError(f"feed {label} depth {depth}: the batch copies "
                             f"should come from pinned memory on a stream "
                             f"that runs no kernel of the step: {copies}")
    return {"losses": losses, "seconds": seconds[FEED_WARM:],
            "copies": copies}


def _check_prefetched(label: str, numpy_batches: list) -> int:
    """Each batch that `device_prefetch` hands over at depth 2 equals its
    numpy batch copied synchronously (`torch.from_numpy(...).cuda()`, token
    ids and labels int64), bit for bit and in its dtype. Returns the
    batches checked."""
    n = 0
    for want, got in zip(numpy_batches, device_prefetch(
            iter(numpy_batches), device_put("cuda"), 2)):
        for key, value in want.items():
            ref = torch.from_numpy(np.ascontiguousarray(value)).cuda()
            if key.startswith("text_") and key != "text_mask":
                ref = ref.long()
            if got[key].dtype != ref.dtype or not torch.equal(got[key], ref):
                raise AssertionError(f"feed {label}: prefetched {key} of "
                                     f"batch {n} differs from its copy")
        n += 1
    if n != len(numpy_batches):
        raise AssertionError(f"feed {label}: {n} of {len(numpy_batches)} "
                             f"batches handed over")
    return n


def feed_runs() -> list:
    """The runs of the feed phase, full width, bf16, weights from a seed, as
    (label, build() -> a fresh train step, source() -> an iterator of numpy
    batches, a few of those batches): pretrain b16 4f over the port's
    DataLoader (4 worker threads) on `SyntheticVideoTextDataset`, and the
    32-frame Charades-Ego fine-tune (configs/ft_charades.json, B=8, S=6273)
    cycling three `synthetic_dual_batch` batches made once, so that the
    host's RNG (about 40 M floats a batch) is not what gets timed."""
    n_steps = FEED_WARM + FEED_TIMED + FEED_PROFILED
    pre_cfg = load_train_config(None, PRETRAIN_SETS)
    pre_b = pre_cfg.global_batch_size
    # batches to spare, so that the feeder at depth 2 still copies in the
    # profiled steps
    dataset = SyntheticVideoTextDataset(pre_cfg,
                                        length=(n_steps + 4) * pre_b)

    def pretrain_source():
        return DataLoader(dataset, pre_b, num_workers=4).epoch(0)

    ft_cfg = cli.dual_config(load_train_config(
        FINETUNE_CONFIG, FINETUNE_SETS + ["model.remat=false"]), "charades")
    tok = Tokenizer("roberta-base", max_len=ft_cfg.max_text_len,
                    vocab_cap=ft_cfg.model.text.vocab_size)
    rng = np.random.default_rng(0)
    ft_batches = [synthetic_dual_batch(ft_cfg, ft_cfg.global_batch_size, rng,
                                       tok) for _ in range(3)]
    return [
        ("pretrain_b16_4f", lambda: build_pretrain(pre_cfg, "cuda")[3],
         pretrain_source, list(itertools.islice(pretrain_source(), 3))),
        ("ft_charades_32f", lambda: build_dual(ft_cfg, "cuda")[3],
         lambda: itertools.cycle(ft_batches), ft_batches),
    ]


def phase_feed(smi: str) -> None:
    """The pinned side-stream batch feed on the training paths (`feed_runs`),
    each at depth 0 and 2 from the same seed. Prints the wall clock a step,
    the device time and streams of the host-to-device copies and their
    share inside the steps, and checks that prefetching changes no
    value."""
    for label, build, source, sample in feed_runs():
        t0 = time.perf_counter()
        by_depth = {}
        for depth in FEED_DEPTHS:
            by_depth[depth] = _feed_run(label, build, source, depth)
            _free()
        a, b = (by_depth[d]["losses"] for d in FEED_DEPTHS)
        worst = max(abs(x[k] - y[k]) / max(abs(y[k]), 1e-30)
                    for x, y in zip(a, b) for k in x)
        if not worst <= FEED_LOSS_RTOL:
            raise AssertionError(f"feed {label}: the losses at depths "
                                 f"{FEED_DEPTHS} differ by {worst:.3e} "
                                 f"(relative) > {FEED_LOSS_RTOL}: {a} {b}")
        checked = _check_prefetched(label, sample)
        for depth, r in by_depth.items():
            ms = [x * 1e3 for x in r["seconds"]]
            c = r["copies"]
            print(f"[6 feed] {label} depth {depth} ({smi}): wall clock a "
                  f"step over {len(ms)} timed, median {np.median(ms):.2f} ms, "
                  f"mean {np.mean(ms):.2f} ms, {[round(x, 1) for x in ms]} | "
                  f"profiled {FEED_PROFILED} steps: {c['copies']} host-to-"
                  f"device copies of >= 1 MiB, {c['copy_mb']:.1f} MB, device "
                  f"{c['copy_ms']:.3f} ms ({c['copy_kinds']}) on streams "
                  f"{c['copy_streams']}, kernels on streams "
                  f"{c['kernel_streams']}; of the copies {c['in_busy_ms']:.3f}"
                  f" ms inside the device's busy periods, "
                  f"{c['under_kernels_ms']:.3f} ms under a running kernel; "
                  f"pinned host allocations and "
                  f"frees {c['pinned_alloc_calls'] or 'none'}", flush=True)
        same = a == b
        print(f"[6 feed] {label}: losses at depths {FEED_DEPTHS} "
              f"{'bit for bit equal' if same else f'within {worst:.3e}'} "
              f"(tol {FEED_LOSS_RTOL:.0e} relative) over "
              f"{FEED_WARM + FEED_TIMED} steps, first step "
              f"{a[0]}; {checked} prefetched batches bit for bit equal to "
              f"their synchronous copies; {time.perf_counter() - t0:.1f} s",
              flush=True)
        del by_depth
        _free()


def _checkout_files() -> set:
    """Every file under the checkout but the built kernels and git's."""
    skip = ("./build", "./.git")
    return {os.path.join(root, name) for root, dirs, files in os.walk(".")
            if not root.startswith(skip) for name in files}


def _pinned_in_use() -> dict:
    """The pinned host memory that PyTorch's caching host allocator still
    holds once its cache is emptied: the blocks handed out and not given
    back. (Its `active_*` counts keep blocks that emptying the cache has
    released, so they are not read.)"""
    torch.cuda.synchronize()
    empty = getattr(torch.accelerator, "empty_host_cache", None)
    (empty or torch._C._host_emptyCache)()
    return {k: v for k, v in torch.cuda.host_memory_stats().items()
            if k in ("allocated_bytes.current", "allocations.current")}


@contextlib.contextmanager
def _validation_launches():
    """Counts the kernel launches of every EgoMCQ validation inside a
    training run apart from the steps': yields a dict that holds them
    once the block has run."""
    from egovlpv2_torch.tasks import egomcq as egomcq_task

    plain, counts = egomcq_task.evaluate_egomcq, dict.fromkeys(KERNELS, 0)

    def counted(step, batches):
        before = dict(_kernels.launch_counts)
        try:
            return plain(step, batches)
        finally:
            for k in counts:
                counts[k] += _kernels.launch_counts[k] - before[k]

    egomcq_task.evaluate_egomcq = counted
    try:
        yield counts
    finally:
        egomcq_task.evaluate_egomcq = plain


def _read_json(path: str):
    with open(path) as f:
        return json.load(f)


def _ms(times: dict) -> dict:
    return {k: [round(x * 1e3, 1) for x in v] for k, v in times.items()}


def _first_difference(want: list, got: list):
    """The first (where, want, got) at which two lists of dicts of floats
    are not the same bits, or None."""
    if len(want) != len(got):
        return ("length", len(want), len(got))
    for i, (a, b) in enumerate(zip(want, got)):
        for k in sorted(set(a) | set(b)):
            if k != "step_ms" and a.get(k) != b.get(k):
                return (f"row {i} {k}", a.get(k), b.get(k))
    return None


def phase_loop(smi: str) -> dict:
    """The training loop of `cli pretrain` at full width (pretrain b16 4f
    bf16, weights from the seed), in a temporary directory outside the
    checkout, with a synthetic EgoMCQ validation (VTC and VTM) after each
    epoch and the monitor on. Run C: two epochs of two steps, uninterrupted.
    Run A: one epoch with --init_val, saved. Run B: two epochs with
    --resume, from A's save. B's losses of steps 3-4 and its validation
    after epoch 1 (the accuracies, and the raw VTC/VTM scores, finite)
    must be C's bits. Then `egomcq --ckpt` on A/B's
    checkpoints must run with the best step's parameters exactly. Returns
    the launch counts of C's validations."""
    t_phase = time.perf_counter()
    files_before, pinned_before = _checkout_files(), _pinned_in_use()
    base = ["pretrain", "--synthetic", "--device", "cuda", "--steps_per_epoch",
            str(LOOP_STEPS), "--val_synthetic", "--val_batches",
            str(LOOP_VAL_BATCHES), "--monitor", LOOP_MONITOR, "--set",
            *PRETRAIN_SETS]
    with tempfile.TemporaryDirectory(prefix="chip_smoke_loop_") as tmp:
        save, ckpt_dir = os.path.join(tmp, "run"), os.path.join(tmp, "run",
                                                                 "ckpt")
        _reset_counts()
        mark = SPANS.last
        with _validation_launches() as val_counts:
            whole = cli.main(base + ["--epochs", "2"])
        steps = 2 * LOOP_STEPS
        # the validation between the epochs leaves the graph as it was
        kinds = {"C": _step_kinds(mark)}
        if kinds["C"] != ["eager", "capture"] + ["replay"] * (steps - 2):
            raise AssertionError(f"loop: run C's steps ran {kinds['C']}")
        python = _python_steps(kinds["C"])
        step_counts = {k: _kernels.launch_counts[k] - val_counts[k]
                       for k in KERNELS}
        if any(step_counts[k] < python for k in BF16_PATH_KERNELS) \
                or any(step_counts[k] for k in GENERAL_KERNELS):
            raise AssertionError(f"loop: the steps' launches {step_counts}")
        if not all(val_counts[k] for k in LOOP_VAL_KERNELS):
            raise AssertionError(f"loop: the validation's launches "
                                 f"{val_counts}")
        whole_rows, whole_val = whole["logged"], whole["val"]
        whole_scores = whole["val_scores"]
        val_seconds = whole["val_seconds"]
        val_step_seconds = [s for one in whole["val_step_seconds"]
                            for s in one]
        del whole
        _free()
        cut = cli.main(base + ["--epochs", "1", "--save_dir", save,
                               "--ckpt_every", "1000", "--init_val"])
        size = os.path.getsize(os.path.join(ckpt_dir, f"step_{LOOP_STEPS}.pt"))
        written = sorted(os.listdir(ckpt_dir))
        progress = _read_json(os.path.join(ckpt_dir, "progress.json"))
        if progress["epoch"] != 0 or not {"monitor.json", "best_step.json"} \
                <= set(written) or not os.path.exists(
                    os.path.join(save, "config.json")):
            raise AssertionError(f"loop: run A saved {written}, progress "
                                 f"{progress}")
        cut_saves = cut["save_seconds"]
        del cut
        _free()
        free_gb = shutil.disk_usage(tmp).free / 1e9
        mark = SPANS.last
        resumed = cli.main(base + ["--epochs", "2", "--save_dir", save,
                                   "--resume"])
        kinds["B"] = _step_kinds(mark)
        if kinds["B"] != ["eager", "capture"][:steps - LOOP_STEPS]:
            raise AssertionError(f"loop: run B's steps ran {kinds['B']}")
        with open(os.path.join(save, "info.log")) as f:
            log_text = f.read()
        for line in (f"resumed from step {LOOP_STEPS} (epoch 1)",
                     "restored monitor"):
            if line not in log_text:
                raise AssertionError(f"loop: run B did not log {line!r}")
        for what, want, got in (("losses", whole_rows[LOOP_STEPS:],
                                 resumed["logged"]),
                                ("validation", whole_val[1:], resumed["val"])):
            diff = _first_difference(want, got)
            if diff is not None:
                raise AssertionError(f"loop: run B's {what} after the resume "
                                     f"differ from run C's at {diff[0]}: C "
                                     f"{diff[1]!r}, B {diff[2]!r}")
        # the raw VTC/VTM scores of each validation, finite, and B's after
        # epoch 1 the same bits as C's: the accuracies of 4 questions alone
        # would hold for almost any model state
        for run, scores in (("C", whole_scores),
                            ("B", resumed["val_scores"])):
            for i, one in enumerate(scores):
                if set(one) != {"vtc", "vtm"} or not all(
                        v.shape == (4 * LOOP_VAL_BATCHES, 5)
                        and np.isfinite(v).all() for v in one.values()):
                    raise AssertionError(
                        f"loop: run {run}'s validation {i} scores "
                        f"{ {k: v.tolist() for k, v in one.items()} }")
        for k in ("vtc", "vtm"):
            want, got = whole_scores[1][k], resumed["val_scores"][0][k]
            if want.dtype != got.dtype or want.tobytes() != got.tobytes():
                first = int(np.flatnonzero(want.ravel() != got.ravel())[0])
                raise AssertionError(
                    f"loop: run B's {k} scores after the resume differ from "
                    f"run C's at flat index {first}: C "
                    f"{want.ravel()[first]!r}, B {got.ravel()[first]!r}")
        times = {"save A": cut_saves, "save B": resumed["save_seconds"],
                 "restore B": resumed["restore_seconds"],
                 "validation a batch, C": [s / LOOP_VAL_BATCHES
                                           for s in val_seconds],
                 "eval step, C": val_step_seconds}
        del resumed
        _free()
        best = _read_json(os.path.join(ckpt_dir, "best_step.json"))["step"]
        _reset_counts()
        mcq = cli.main(["egomcq", "--device", "cuda", "--ckpt", ckpt_dir,
                        "--val_batches", "1", "--set", *PRETRAIN_SETS])
        mcq_counts = dict(_kernels.launch_counts)
        saved = torch.load(os.path.join(ckpt_dir, f"step_{best}.pt"),
                           map_location="cpu", weights_only=True)["model"]
        got = mcq["model"].state_dict()
        if set(got) != set(saved) or not all(
                torch.equal(got[k].cpu(), v) for k, v in saved.items()):
            raise AssertionError(f"loop: egomcq --ckpt did not run with the "
                                 f"parameters of step {best}")
        if not all(mcq_counts[k] for k in LOOP_VAL_KERNELS):
            raise AssertionError(f"loop: egomcq --ckpt launches {mcq_counts}")
        times["restore egomcq"] = [mcq["ckpt_seconds"]]
        del mcq, saved, got
        _free()
    files_after, pinned_after = _checkout_files(), _pinned_in_use()
    if os.path.exists(tmp) or files_after != files_before:
        raise AssertionError(f"loop: files left behind: "
                             f"{sorted(files_after - files_before)} {tmp}")
    if pinned_after != pinned_before:
        raise AssertionError(f"loop: pinned host memory left in use: "
                             f"{pinned_before} -> {pinned_after}")
    head, ms = f"[7 loop] ({smi})", _ms(times)
    print(f"{head} pretrain b16 4f bf16, {LOOP_STEPS} steps an epoch, a "
          f"validation of {LOOP_VAL_BATCHES} x 4 questions (VTC and VTM) "
          f"after each: run B (resumed at step {LOOP_STEPS}) equals run C "
          f"bit for bit in the losses of steps {LOOP_STEPS + 1}-{steps} "
          f"({[r['loss_total'] for r in whole_rows[LOOP_STEPS:]]}) and the "
          f"validation after epoch 1 ({whole_val[1]}; its VTC scores "
          f"{whole_scores[1]['vtc'].tolist()}, VTM "
          f"{whole_scores[1]['vtm'].tolist()}); egomcq --ckpt ran "
          f"with the parameters of step {best} exactly", flush=True)
    print(f"{head} checkpoint {size} bytes ({size / 2**30:.3f} GiB), "
          f"{free_gb:.1f} GB free beside it", flush=True)
    print(f"{head} save ms: run A {ms['save A']}, run B {ms['save B']}; "
          f"restore ms: run B's --resume {ms['restore B']}, egomcq --ckpt "
          f"{ms['restore egomcq']}", flush=True)
    print(f"{head} validation ms a batch, run C: its eval steps alone "
          f"(from the host batch to the end of its device work, the input "
          f"copy included) {ms['eval step, C']}; the whole validation a "
          f"batch (the synthetic batch's host RNG included) "
          f"{ms['validation a batch, C']}", flush=True)
    print(f"{head} steps ran {kinds} | launches a step, over run C's "
          f"{python} whose wrappers ran "
          f"{ {k: v / python for k, v in step_counts.items()} }, run C's "
          f"{len(whole_val)} validations {val_counts}, egomcq --ckpt "
          f"{mcq_counts}; no file left, pinned host memory held "
          f"{pinned_after} as before", flush=True)
    print(f"{head} {time.perf_counter() - t_phase:.1f} s", flush=True)
    return val_counts


def _write_mq_files(root: str, rng: np.random.Generator) -> tuple:
    """Ego4D moments jsons (train, val), ego4d.json and [T, 4096] float32
    clip features: MQ_TRAIN_CLIPS + MQ_VAL_CLIPS clips of 200 to 928
    feature frames, 2 to 6 primary moments each, the labels round robin
    over MQ_CLASSES. Returns the paths of the two moments files and the
    info file."""
    videos = {"train": [], "val": []}
    info = []
    n = 0
    for split, clips in (("train", MQ_TRAIN_CLIPS), ("val", MQ_VAL_CLIPS)):
        for i in range(clips):
            clip = f"{split}_clip_{i:03d}"
            frames = int(rng.integers(200, 929))
            np.save(os.path.join(root, "features", clip + ".npy"),
                    rng.standard_normal((frames, 4096), dtype=np.float32))
            duration = frames / MQ_FPS
            labels = []
            for _ in range(int(rng.integers(2, 7))):
                start = float(rng.uniform(0, 0.8 * duration))
                labels.append({
                    "label": f"class_{n % MQ_CLASSES:03d}", "primary": True,
                    "start_time": start,
                    "end_time": min(duration, start + float(
                        rng.uniform(2, 0.2 * duration)))})
                n += 1
            videos[split].append({
                "video_uid": f"video_{clip}", "split": split,
                "clips": [{"clip_uid": clip, "video_start_sec": 0.0,
                           "video_end_sec": duration,
                           "annotations": [{"labels": labels}]}]})
            info.append({"video_uid": f"video_{clip}",
                         "duration_sec": duration})
    paths = []
    for split in ("train", "val"):
        paths.append(os.path.join(root, f"moments_{split}.json"))
        with open(paths[-1], "w") as f:
            json.dump({"videos": videos[split]}, f)
    paths.append(os.path.join(root, "ego4d.json"))
    with open(paths[-1], "w") as f:
        json.dump({"videos": info}, f)
    return tuple(paths)


def _write_nlq_files(root: str, rng: np.random.Generator) -> tuple:
    """Ego4D NLQ jsons (train, val) of one query a clip, its fused window
    features [W, 768] (W 128 to 300: longer ones are cut at max_pos_len)
    and raw query tokens [15, 768], as `extract_nlq_features` writes them.
    Returns the two json paths."""
    paths = []
    for split, queries in (("train", NLQ_TRAIN), ("val", NLQ_VAL)):
        videos = []
        for i in range(queries):
            clip, ann = f"{split}_clip_{i:03d}", f"ann_{i:03d}"
            windows = int(rng.integers(128, 301))
            key = os.path.join(root, "features", f"{clip}_{ann}_0")
            np.save(key + ".npy", rng.standard_normal((windows, 768),
                                                      dtype=np.float32))
            np.save(key + "_query.npy",
                    rng.standard_normal((NLQ_TOKENS, 768), dtype=np.float32))
            duration = windows * 16 / 30.0
            start = float(rng.uniform(0, 0.8 * duration))
            videos.append({"video_uid": f"video_{clip}", "clips": [{
                "clip_uid": clip, "video_start_sec": 0.0,
                "video_end_sec": duration, "annotations": [{
                    "annotation_uid": ann, "language_queries": [{
                        "query": f"where did I put object {i}",
                        "clip_start_sec": start,
                        "clip_end_sec": min(duration, start + float(
                            rng.uniform(1, 0.2 * duration)))}]}]}]})
        paths.append(os.path.join(root, f"nlq_{split}.json"))
        with open(paths[-1], "w") as f:
            json.dump({"videos": videos}, f)
    return tuple(paths)


def _write_qfvs_files(root: str, rng: np.random.Generator) -> None:
    """For videos 1-3: QFVS_PAIRS oracle summaries (1-indexed shots, about
    2% of them), dense per-shot tags (one line a shot, concept names), the
    packed shot features P0<v>.npz (20 x 200 x 768 for each of concept1,
    concept2 and oracle; segments of 100 to 200 shots) and one Tags.mat of
    the videos' per-shot concept matrices."""
    concepts = sorted({c for pair in QFVS_PAIRS for c in pair} | {"Street"})
    tags = np.empty((3, 1), object)
    for vid in (1, 2, 3):
        seg_len = rng.integers(100, QFVS_SHOTS + 1, QFVS_SEGMENTS)
        shots = int(seg_len.sum())
        shot_tags = rng.random((shots, len(concepts))) < 0.2
        tags[vid - 1, 0] = shot_tags.astype(np.uint8)
        for sub in ("oracle", "tags"):
            os.makedirs(os.path.join(root, sub, f"P0{vid}"), exist_ok=True)
        with open(os.path.join(root, "tags", f"P0{vid}", f"P0{vid}.txt"),
                  "w") as f:
            for row in shot_tags:
                f.write(",".join(c for c, t in zip(concepts, row) if t) + "\n")
        for c1, c2 in QFVS_PAIRS:
            picked = np.sort(rng.choice(shots, max(shots // 50, 1),
                                        replace=False)) + 1
            with open(os.path.join(root, "oracle", f"P0{vid}",
                                   f"{c1}_{c2}_oracle.txt"), "w") as f:
                f.write("".join(f"{s}\n" for s in picked))
        shape = (QFVS_SEGMENTS, QFVS_SHOTS, 768)
        np.savez(os.path.join(root, "features", f"P0{vid}.npz"),
                 seg_len=seg_len.astype(np.int32),
                 **{k: rng.standard_normal(shape, dtype=np.float32)
                    for k in ("feat_concept1", "feat_concept2",
                              "feat_oracle")})
    scipy_io.savemat(os.path.join(root, "Tags.mat"), {"Tags": tags})


def _median_ms(seconds: list, skip: int = 0) -> float:
    return round(float(np.median(seconds[skip:])) * 1e3, 3)


def _head_run(what: str, argv: list, kernels_expected: tuple,
              rows_expected: dict, steps: int) -> tuple:
    """`cli.main(argv)` on the card with the counts set to 0 and the peak
    memory reset: every metric finite, the hand kernels launched only
    those of `kernels_expected`, K8's launches by row count
    `rows_expected` a step. Returns (its result, its counts, peak GiB)."""
    _free()
    _reset_counts()
    torch.cuda.reset_peak_memory_stats()
    res = cli.main(argv)
    torch.cuda.synchronize()
    peak = torch.cuda.max_memory_allocated() / 2**30
    counts = dict(_kernels.launch_counts)
    rows = dict(_kernels.layernorm_bwd_rows)
    metrics = res["metrics"]
    if not metrics or not all(np.isfinite(v) for v in metrics.values()):
        raise AssertionError(f"{what}: metrics {metrics}")
    if len(res["timings"]["step"]) != steps:
        raise AssertionError(f"{what}: {len(res['timings']['step'])} steps, "
                             f"not {steps}")
    stray = {k: v for k, v in counts.items()
             if v and k not in kernels_expected}
    missing = [k for k in kernels_expected if not counts[k]]
    want_rows = {r: n * steps for r, n in rows_expected.items()}
    if stray or missing or rows != want_rows:
        raise AssertionError(f"{what}: launches {counts}, K8 by rows {rows} "
                             f"(expected {want_rows})")
    return res, counts, peak


def phase_heads(smi: str) -> dict:
    """The downstream heads through their commands at the published widths,
    float32 with TF32 off, on seeded files written to a temporary directory
    outside the checkout: `cli mq-anno` then `cli mq` (VSGN, no hand
    kernel), `cli nlq` (VSLNet) and `cli qfvs` (the summary scorer), whose
    LayerNorms run K7 and K8 on every training step. Returns the launch
    counts of each run."""
    t_phase = time.perf_counter()
    files_before, pinned_before = _checkout_files(), _pinned_in_use()
    rng = np.random.default_rng(8)
    by_path, lines = {}, []
    with tempfile.TemporaryDirectory(prefix="chip_smoke_heads_") as tmp:
        os.makedirs(os.path.join(tmp, "features"))
        t0 = time.perf_counter()
        moments_train, moments_val, info = _write_mq_files(tmp, rng)
        nlq_train, nlq_val = _write_nlq_files(tmp, rng)
        _write_qfvs_files(tmp, rng)
        write_s = time.perf_counter() - t0
        feats = os.path.join(tmp, "features")

        anno = os.path.join(tmp, "clip_annotations.json")
        counts = cli.main(["mq-anno", "--moments",
                           f"{moments_train},{moments_val}", "--info", info,
                           "--features", feats, "--out", anno])
        if counts != {"train": MQ_TRAIN_CLIPS, "val": MQ_VAL_CLIPS}:
            raise AssertionError(f"mq-anno: {counts}")
        out = os.path.join(tmp, "mq_out")
        steps = HEAD_EPOCHS * MQ_TRAIN_CLIPS // MQ_BATCH
        res, by_path["mq_vsgn_b16_t928"], peak = _head_run(
            "mq", ["mq", "--device", "cuda", "--anno", anno, "--features",
                   feats, "--out", out, "--epochs", str(HEAD_EPOCHS),
                   "--batch_size", str(MQ_BATCH)], (), {}, steps)
        with open(os.path.join(out, "moment_classes.json")) as f:
            classes = json.load(f)
        written = sorted(os.listdir(out))
        if len(classes) != MQ_CLASSES + 1 or written != [
                "detections_postNMS.json", "moment_classes.json",
                "retreival_postNMS.json", "submission.json"]:
            raise AssertionError(f"mq: {len(classes)} classes, wrote "
                                 f"{written}")
        with open(os.path.join(out, "submission.json")) as f:
            submission = json.load(f)
        n_det = sum(len(v) for v in submission["detect_results"].values())
        t = res["timings"]
        if len(t["infer"]) != MQ_VAL_CLIPS or not n_det:
            raise AssertionError(f"mq: {len(t['infer'])} windows inferred, "
                                 f"{n_det} detections")
        lines.append(
            f"mq_vsgn_b16_t928 (VSGN T=928 in 4096, hidden 256, 5 levels, "
            f"{MQ_CLASSES} classes + background, batch {MQ_BATCH}): step ms "
            f"{_ms({'s': t['step']})['s']}, median warm "
            f"{_median_ms(t['step'], 1)}; peak {peak:.2f} GiB; inference ms "
            f"a window {_ms({'s': t['infer']})['s']}; proposals + NMS on "
            f"the host ms a window {_ms({'s': t['proposals']})['s']} "
            f"({n_det} detections); mAP_avg "
            f"{res['metrics']['mAP_avg']:.4f}; no hand kernel launched")
        del res
        _free()

        steps = HEAD_EPOCHS * NLQ_TRAIN // NLQ_BATCH
        res, by_path["nlq_vslnet_b32"], peak = _head_run(
            "nlq", ["nlq", "--device", "cuda", "--train_anno", nlq_train,
                    "--val_anno", nlq_val, "--features", feats, "--epochs",
                    str(HEAD_EPOCHS), "--batch_size", str(NLQ_BATCH)],
            HEAD_LN_KERNELS, NLQ_LN_ROWS, steps)
        t = res["timings"]
        if len(t["infer"]) != NLQ_VAL:
            raise AssertionError(f"nlq: {len(t['infer'])} queries inferred")
        lines.append(
            f"nlq_vslnet_b32 (VSLNet dim 128, 8 heads, max_pos_len 256, "
            f"768-d features, batch {NLQ_BATCH}): step ms "
            f"{_ms({'s': t['step']})['s']}, median warm "
            f"{_median_ms(t['step'], 1)}; peak {peak:.2f} GiB; inference ms "
            f"a query {_ms({'s': t['infer']})['s']}; metrics {res['metrics']};"
            f" K7 {by_path['nlq_vslnet_b32']['layernorm_fwd']}, K8 "
            f"{by_path['nlq_vslnet_b32']['layernorm_bwd']} launches, K8 a "
            f"step by rows {NLQ_LN_ROWS}")
        del res
        _free()

        steps = HEAD_EPOCHS * 2 * len(QFVS_PAIRS)
        res, by_path["qfvs_scorer_20x200"], peak = _head_run(
            "qfvs", ["qfvs", "--device", "cuda", "--oracle",
                     os.path.join(tmp, "oracle"), "--tags",
                     os.path.join(tmp, "tags"), "--tags_mat",
                     os.path.join(tmp, "Tags.mat"), "--features", feats,
                     "--train_videos", "1,2", "--test_video", "3",
                     "--epochs", str(HEAD_EPOCHS)],
            HEAD_LN_KERNELS, QFVS_LN_ROWS, steps)
        t = res["timings"]
        if len(t["infer"]) != len(QFVS_PAIRS):
            raise AssertionError(f"qfvs: {len(t['infer'])} items scored")
        lines.append(
            f"qfvs_scorer_20x200 (d_model 768, 2 heads, 2 layers, "
            f"{QFVS_SEGMENTS} x {QFVS_SHOTS} shots): step ms "
            f"{_ms({'s': t['step']})['s']}, median warm "
            f"{_median_ms(t['step'], 1)}; peak {peak:.2f} GiB; inference ms "
            f"an item {_ms({'s': t['infer']})['s']}; F1 "
            f"{res['metrics']['F1']:.3f}; K7 "
            f"{by_path['qfvs_scorer_20x200']['layernorm_fwd']}, K8 "
            f"{by_path['qfvs_scorer_20x200']['layernorm_bwd']} launches, K8 "
            f"a step by rows {QFVS_LN_ROWS}")
        del res
        _free()
    files_after, pinned_after = _checkout_files(), _pinned_in_use()
    if os.path.exists(tmp) or files_after != files_before:
        raise AssertionError(f"heads: files left behind: "
                             f"{sorted(files_after - files_before)} {tmp}")
    if pinned_after != pinned_before:
        raise AssertionError(f"heads: pinned host memory left in use: "
                             f"{pinned_before} -> {pinned_after}")
    head = f"[8 heads] ({smi})"
    for line in lines:
        print(f"{head} {line}", flush=True)
    print(f"{head} seeded files written in {write_s:.1f} s; LayerNorm "
          f"inputs copied {dict(ln.contiguous_copies)}; no file left, pinned "
          f"host memory held {pinned_after} as before; "
          f"{time.perf_counter() - t_phase:.1f} s", flush=True)
    return by_path


# One rank of phase 9: the command line's pretrain, its launches counted
# from 0 in this process, with TF32 off as phase 1 sets it; the device time
# of the step's gradient mean and of its forward gathers between CUDA
# events around each call, and the peak of device memory.
_DIST_CHILD = """
import json, sys
import torch
from egovlpv2_torch import cli
from egovlpv2_torch.ops import _kernels
from egovlpv2_torch.train import step
torch.backends.cuda.matmul.allow_tf32 = False
torch.backends.cudnn.allow_tf32 = False
events = {"sync_gradients": [], "all_gather": []}

def timed(name):
    fn = getattr(step, name)

    def call(*args, **kwargs):
        start, end = (torch.cuda.Event(enable_timing=True) for _ in "se")
        start.record()
        out = fn(*args, **kwargs)
        end.record()
        events[name].append((start, end))
        return out
    setattr(step, name, call)

for name in events:
    timed(name)
_kernels.reset_launch_counts()
res = cli.main(sys.argv[2:])
torch.cuda.synchronize()
with open(sys.argv[1], "w") as f:
    json.dump({"logged": res["logged"], "step_seconds": res["step_seconds"],
               "counts": dict(_kernels.launch_counts),
               "peak": torch.cuda.max_memory_allocated(),
               "ms": {name: [s.elapsed_time(e) for s, e in pairs]
                      for name, pairs in events.items()}}, f)
"""


def _child_env() -> dict:
    """The environment of a phase-9 child: this one's, without a launcher's
    LOCAL_RANK (each child names its card through the flags)."""
    env = {k: v for k, v in os.environ.items() if k != "LOCAL_RANK"}
    env["PYTHONPATH"] = os.getcwd() + os.pathsep + env.get("PYTHONPATH", "")
    return env


def _eager_pretrain(argv: list) -> dict:
    """`cli <argv>` in this process with the eager step where the step
    would replay a CUDA graph: its logged rows, step ms and peak memory."""
    decide = train_step_module.captures_graph
    train_step_module.captures_graph = lambda *args: False
    torch.cuda.reset_peak_memory_stats()
    try:
        res = cli.main(argv)
    finally:
        train_step_module.captures_graph = decide
    out = {"rows": res["logged"],
           "step_ms": [x * 1e3 for x in res["step_seconds"]],
           "peak": torch.cuda.max_memory_allocated()}
    del res
    _free()
    return out


def _worst_rtol(rows: list, ref: list) -> list:
    """The largest relative difference of the losses, a step."""
    return [max(abs(a[k] - b[k]) / abs(b[k]) for k in a
                if k.startswith("loss_")) for a, b in zip(rows, ref)]


def phase_dist(smi: str, single: dict) -> dict:
    """`cli pretrain` under NCCL at world size 1, against the same run
    without a group and with the eager step; phase 5's (`single`: its
    logged rows), whose step replays a CUDA graph, beside it. Then two
    ranks on one card refused. Returns the launches of the run."""
    t0 = time.perf_counter()
    alone = ["pretrain", "--synthetic", "--device", "cuda",
             "--steps_per_epoch", str(DIST_STEPS), "--set", *PRETRAIN_SETS]
    plain = _eager_pretrain(alone)
    argv = alone + ["--coordinator", f"localhost:{free_port()}",
                    "--num_processes", "1", "--process_id", "0"]
    with tempfile.TemporaryDirectory() as tmp:
        out = os.path.join(tmp, "dist.json")
        codes, logs = run_ranks([[sys.executable, "-c", _DIST_CHILD, out,
                                  *argv]], DIST_TIMEOUT, env=_child_env())
        if codes != [0]:
            raise AssertionError(f"pretrain under NCCL ended with {codes}:\n"
                                 f"{logs[0][-6000:]}")
        with open(out) as f:
            res = json.load(f)
    topo = next((line for line in logs[0].splitlines()
                 if line.startswith("# multihost:")), "")
    if not topo.startswith("# multihost: process 0/1") or "nccl" not in topo:
        raise AssertionError(f"no NCCL group of one: {topo!r}")
    rows = res["logged"]
    if len(rows) != DIST_STEPS:
        raise AssertionError(f"pretrain under NCCL logged {len(rows)} steps")
    keys = [k for k in rows[0] if k.startswith("loss_")]
    first = {k: rows[0][k] for k in keys}
    want = {k: plain["rows"][0][k] for k in keys}
    if first != want or {k: single["rows"][0][k] for k in keys} != want:
        raise AssertionError(f"first loss under NCCL {first} is not the one "
                             f"without a group {want} (phase 5 "
                             f"{single['rows'][0]})")
    for got, ref in zip(rows[1:], plain["rows"][1:]):
        for k in keys:
            if not abs(got[k] - ref[k]) <= DIST_LOSS_RTOL * abs(ref[k]):
                raise AssertionError(f"step {got['step']} {k}: {got[k]} under "
                                     f"NCCL, {ref[k]} without a group")
    counts = res["counts"]
    per_step = {k: counts.get(k, 0) / DIST_STEPS for k in KERNELS}
    if not all(per_step[k] >= 1 and per_step[k] == int(per_step[k])
               for k in BF16_PATH_KERNELS) \
            or any(per_step[k] for k in GENERAL_KERNELS):
        raise AssertionError(f"pretrain under NCCL: launches a step "
                             f"{per_step}")
    group_ms = [s * 1e3 for s in res["step_seconds"]]
    # the first two steps carry warm-up, in both runs
    warm, warm_single = (float(np.median(ms[2:]))
                         for ms in (group_ms, plain["step_ms"]))
    sync_ms = res["ms"]["sync_gradients"]
    gathers = res["ms"]["all_gather"]
    if len(sync_ms) != DIST_STEPS or len(gathers) % DIST_STEPS:
        raise AssertionError(f"{len(sync_ms)} gradient means and "
                             f"{len(gathers)} gathers in {DIST_STEPS} steps")
    per = len(gathers) // DIST_STEPS
    gather_ms = [sum(gathers[i * per:(i + 1) * per])
                 for i in range(DIST_STEPS)]
    run_s = time.perf_counter() - t0

    # two ranks on the one card: refused on both, before any collective
    t1 = time.perf_counter()
    port = free_port()
    codes, logs = run_ranks(
        [[sys.executable, "-m", "egovlpv2_torch.cli", "pretrain",
          "--synthetic", "--device", "cuda", "--coordinator",
          f"localhost:{port}", "--num_processes", "2", "--process_id",
          str(i)] for i in range(2)], REFUSE_TIMEOUT, env=_child_env())
    refuse_s = time.perf_counter() - t1
    refused = ["two ranks on one device: ranks [0, 1]" in log for log in logs]
    if any(code <= 0 for code in codes) or not all(refused):
        raise AssertionError(f"two ranks on one card: exit codes {codes} "
                             f"(negative: killed at {REFUSE_TIMEOUT} s), "
                             f"refusal seen {refused}:\n"
                             + "\n---\n".join(log[-3000:] for log in logs))
    reason = next(line for line in logs[0].splitlines()
                  if "two ranks on one device" in line)
    print(f"[9 multiprocess] pretrain b16 4f bf16 under {topo[2:]}: "
          f"{DIST_STEPS} steps, losses {[r['loss_total'] for r in rows]} "
          f"(first bit for bit the run without a group and with the eager "
          f"step, {plain['rows'][0]['loss_total']}; then within "
          f"{DIST_LOSS_RTOL} of {[r['loss_total'] for r in plain['rows'][1:DIST_STEPS]]}:"
          f" {[f'{x:.2e}' for x in _worst_rtol(rows, plain['rows'])]}; "
          f"phase 5's replayed steps from that run "
          f"{[f'{x:.2e}' for x in _worst_rtol(single['rows'], plain['rows'])]})"
          f" | step ms with the group {[round(x, 1) for x in group_ms]}, "
          f"without {[round(x, 1) for x in plain['step_ms']]}"
          f", median of steps 3-{DIST_STEPS} {warm:.1f} ms with against "
          f"{warm_single:.1f} ms without | device ms a step (CUDA events): "
          f"the gradient mean {[round(x, 2) for x in sync_ms]}, median of "
          f"steps 3-{DIST_STEPS} {float(np.median(sync_ms[2:])):.2f}; the "
          f"{per} forward gathers {[round(x, 2) for x in gather_ms]}, median "
          f"{float(np.median(gather_ms[2:])):.2f} | peak memory "
          f"{res['peak'] / 2**30:.2f} GiB with against "
          f"{plain['peak'] / 2**30:.2f} GiB without | launches a step "
          f"{per_step} | run {run_s:.1f} s | two ranks "
          f"on one card refused in {refuse_s:.1f} s, exit codes {codes}: "
          f"{reason.strip()} | {smi}", flush=True)
    return {k: counts.get(k, 0) for k in KERNELS}


# One run of phase 10: `cli bench` as a user runs it, its launches counted
# from 0 in this process; in step BENCH_SYNC_STEP (a timed one) every host
# synchronisation that goes through PyTorch warns (sync debug mode) and is
# recorded with its Python line; the batch the bench reuses is copied at
# its first step and compared after its last.
_BENCH_CHILD = """
import json, sys, warnings
import torch
from torch.profiler import ProfilerActivity, profile
from chip_smoke import _hand_launches, _python_steps, _step_kinds
from egovlpv2_torch import bench, cli
from egovlpv2_torch.ops import _kernels
from egovlpv2_torch.utils.logging import SPANS
out, sync_step, witness = sys.argv[1], int(sys.argv[2]), int(sys.argv[3])
build = bench.build_pretrain
seen = {"steps": 0, "syncs": [], "hand": {}}

def counted(cfg, device):
    *trainer, step = build(cfg, device)

    def call(batch):
        seen["steps"] += 1
        if seen["steps"] == 1:
            seen["batch"] = batch
            seen["before"] = {k: v.clone() for k, v in batch.items()}
        if seen["steps"] in (1, witness):
            mark = SPANS.last
            with profile(activities=[ProfilerActivity.CUDA]) as prof:
                metrics = step(batch)
                torch.cuda.synchronize()
            seen["hand"][seen["steps"]] = [_step_kinds(mark),
                                           _hand_launches(prof)]
            return metrics
        if seen["steps"] != sync_step:
            return step(batch)
        torch.cuda.set_sync_debug_mode("warn")
        try:
            with warnings.catch_warnings(record=True) as caught:
                warnings.simplefilter("always")
                metrics = step(batch)
        finally:
            torch.cuda.set_sync_debug_mode("default")
        seen["syncs"] = [[str(w.message).splitlines()[0],
                          f"{w.filename}:{w.lineno}"] for w in caught]
        return metrics
    return (*trainer, call)

bench.build_pretrain = counted
_kernels.reset_launch_counts()
mark = SPANS.last
cli.main(sys.argv[4:])
kinds = _step_kinds(mark)
with open(out, "w") as f:
    json.dump({"steps": seen["steps"], "syncs": seen["syncs"],
               "counts": dict(_kernels.launch_counts), "kinds": kinds,
               "python_steps": _python_steps(kinds), "hand": seen["hand"],
               "batch_unchanged": all(torch.equal(seen["batch"][k], v)
                                      for k, v in seen["before"].items()),
               "peak": torch.cuda.max_memory_allocated()}, f)
"""


def _draw_and_put_ms(cfg) -> tuple:
    """The host's ms to draw one global batch of `cfg` and to put it on the
    card (pinned, copied, waited for), BENCH_DRAWS times each."""
    draws, puts = [], []
    for i in range(BENCH_DRAWS):
        t0 = time.perf_counter()
        batch = synthetic_batch(cfg, cfg.global_batch_size,
                                np.random.default_rng(i))
        t1 = time.perf_counter()
        device_put(torch.device("cuda"))(batch).wait()
        torch.cuda.synchronize()
        t2 = time.perf_counter()
        draws.append((t1 - t0) * 1e3)
        puts.append((t2 - t1) * 1e3)
    return draws, puts


def phase_bench(smi: str, single: dict) -> dict:
    """`cli bench --device cuda` at its defaults in a child process, beside
    phase 5's step (`single`). Returns the launches of the run."""
    t0 = time.perf_counter()
    cfg = bench_config({}, 1)
    draws, puts = _draw_and_put_ms(cfg)
    _free()
    env = {k: v for k, v in _child_env().items()
           if not k.startswith("BENCH_")}
    argv = ["bench", "--device", "cuda"]
    with tempfile.TemporaryDirectory() as tmp:
        out = os.path.join(tmp, "bench.json")
        codes, logs = run_ranks([[sys.executable, "-c", _BENCH_CHILD, out,
                                  str(BENCH_SYNC_STEP), str(BENCH_WARMUP),
                                  *argv]],
                                BENCH_TIMEOUT, env=env)
        if codes != [0]:
            raise AssertionError(f"cli bench ended with {codes}:\n"
                                 f"{logs[0][-6000:]}")
        with open(out) as f:
            res = json.load(f)
    lines = [line for line in logs[0].splitlines()
             if line.startswith('{"metric"')]
    if len(lines) != 1:
        raise AssertionError(f"cli bench printed {len(lines)} records:\n"
                             f"{logs[0][-6000:]}")
    record = json.loads(lines[0])
    detail = record["detail"]
    if not (np.isfinite(record["value"]) and record["value"] > 0
            and detail["devices"] == 1
            and detail["global_batch"] == cfg.global_batch_size == 16
            and np.isfinite(detail["loss"])):
        raise AssertionError(f"cli bench: {record}")
    steps = BENCH_WARMUP + BENCH_ITERS
    if res["steps"] != steps:
        raise AssertionError(f"cli bench ran {res['steps']} steps")
    if not res["batch_unchanged"]:
        raise AssertionError("cli bench: a step changed the batch it reuses")
    counts, kinds, python = res["counts"], res["kinds"], res["python_steps"]
    # remat off, one card: every step after the capture replays
    if kinds != ["eager", "capture"] + ["replay"] * (steps - 2):
        raise AssertionError(f"cli bench: steps ran {kinds}")
    hand = {int(n): v for n, v in res["hand"].items()}
    _check_witness("cli bench", hand, 1, BENCH_WARMUP)
    per_step = {k: counts.get(k, 0) / python for k in KERNELS}
    if not all(per_step[k] >= 1 and per_step[k] == int(per_step[k])
               for k in BF16_PATH_KERNELS) \
            or any(per_step[k] for k in GENERAL_KERNELS):
        raise AssertionError(f"cli bench: launches a step {per_step}")
    syncs = [s for s in res["syncs"] if "synchroniz" in s[0]]
    where = sorted({loc for _, loc in syncs})
    warm = float(np.median(single["step_ms"][2:]))
    print(f"[10 bench] {' '.join(argv)} (BENCH_BATCH 16, no remat, full "
          f"width, bf16): {lines[0]} | steps ran {kinds} (steps 1 and "
          f"{BENCH_WARMUP} profiled) | launches a step, over the {python} "
          f"whose wrappers ran {per_step} | hand kernels on the device, step "
          f"1 (eager) {hand[1][1]}, step {BENCH_WARMUP} "
          f"({hand[BENCH_WARMUP][0][0]}) the same | host "
          f"synchronisations in timed step {BENCH_SYNC_STEP - BENCH_WARMUP} "
          f"(sync debug mode) {len(syncs)}: {where} | the host's draw of one "
          f"batch of 16 {[round(x, 1) for x in draws]} ms, its put "
          f"{[round(x, 1) for x in puts]} ms | phase 5's median of steps "
          f"3-{PRETRAIN_STEPS} (draw and put in each) {warm:.1f} ms against "
          f"the bench's {detail['step_ms']} ms | batch unchanged after "
          f"{steps} steps | peak memory {res['peak'] / 2**30:.2f} GiB (a "
          f"graph's pool not in it) | "
          f"phase {time.perf_counter() - t0:.1f} s | {smi}", flush=True)
    return {k: counts.get(k, 0) for k in KERNELS}, python


def main() -> None:
    smi = phase_device()
    phase_build()
    results = phase_kernels()
    phase_tiny()
    phase_tiny_qa()
    phase_tiny_extract()
    by_path = phase_egomcq()
    by_path["pretrain"], single = phase_pretrain()
    by_path.update(phase_finetune())
    by_path.update(phase_extract())
    by_path["taskqa"] = phase_taskqa()
    phase_feed(smi)
    by_path["pretrain_val"] = phase_loop(smi)
    by_path.update(phase_heads(smi))
    by_path["pretrain_dist"] = phase_dist(smi, single)
    by_path["bench"], bench_python = phase_bench(smi, single)
    for path in ("egomcq_16f", "egomcq_4f", "egomcq_16f_1q", "pretrain",
                 "pretrain_dist", "bench"):
        if not by_path[path]["fused_attention_fwd"]:
            raise AssertionError(f"{path}: K9 was not launched")
    bad = sorted(m for m in sys.modules
                 if m.split(".")[0] in ("jax", "jaxlib", "flax", "optax",
                                        "egovlpv2_tpu"))
    if bad:
        raise AssertionError(f"the port imported {bad}")
    # `launches` is the count of the kernel's main path's own run: the
    # pretrain run for K1-K9 (the bf16 paths), the EgoTaskQA run (steps and
    # evaluation) for K10/K11; each path's count stands beside it, never
    # summed. A wrapper call is one count: K4 in its frame form and K5 in
    # its tensor-core form are one __global__ launch (phase 3 checks K4's),
    # their grouped forms two (a query pass, then a key pass); K3, K6 and
    # the LayerNorm backward two (a pass, then the merge or sum of the
    # blocks' partials); K10 two and K11 three.
    # pretrain_val: the validation batches of the loop phase's run C. A
    # step replayed as one CUDA graph calls no wrapper: the pretrain and
    # bench runs count the steps whose wrappers ran (the eager one and the
    # one that captured); their replays' kernels are witnessed by name
    # from the profiler in phases 5 and 10.
    steps = {"pretrain": single["python_steps"], "taskqa": TASKQA_STEPS,
             "pretrain_val": 2 * LOOP_VAL_BATCHES,
             "pretrain_dist": DIST_STEPS,
             "bench": bench_python,
             "mq_vsgn_b16_t928": HEAD_EPOCHS * MQ_TRAIN_CLIPS // MQ_BATCH,
             "nlq_vslnet_b32": HEAD_EPOCHS * NLQ_TRAIN // NLQ_BATCH,
             "qfvs_scorer_20x200": HEAD_EPOCHS * 2 * len(QFVS_PAIRS)}
    print(json.dumps({"kernels": [
        {"name": k, "route": "cuda", "source": KERNELS[k][0],
         "replaces": KERNELS[k][1],
         **({"also_replaces": ALSO_REPLACES[k]} if k in ALSO_REPLACES else {}),
         "main_path": MAIN_PATH[k], "launches": by_path[MAIN_PATH[k]][k],
         "launches_by_path": {path: c[k] for path, c in by_path.items()},
         **results[k]}
        for k in KERNELS], "steps_by_path": steps}))
    print(smi)
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": torch.cuda.get_device_name(0),
        "count": torch.cuda.device_count()}}))


if __name__ == "__main__":
    main()
