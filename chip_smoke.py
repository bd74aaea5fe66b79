#!/usr/bin/env python3
"""On-card smoke test of the PyTorch/CUDA port (``mxnet_tpu_torch``).

Run from the root of a checkout on a machine with one NVIDIA H100:

    python3 chip_smoke.py

It builds the hand-written kernels from ``mxnet_tpu_torch/csrc`` (into
``build/``), holds each against its plain PyTorch version on the card
(flash-attention forward K1, backward dQ K2 and dK/dV K3, each in bf16
and in float32), serves a
GPT-2-small-width transformer LM (random weights from a seed) through
``DynamicBatcher`` -> ``BucketedPredictor`` on ``cuda:0``, checks the
replies and one full-width request in float32 against the CPU, then
trains the same LM through ``Module`` + ``NDArrayIter`` on ``cuda:0``
(bf16 compute, fp32 masters) and checks one float32 training step,
which launches K1-K3 in float32 once a layer, against the same step on
the CPU.  Then it trains ResNet-50 at ImageNet
width through ``Module`` with the JAX package's ``bench.py`` recipe
(batch 256, bf16 compute, SGD with momentum), profiles a step, checks
one float32 step at full depth and width against the CPU, and runs
``Module.fit`` with a checkpoint that must reload bit for bit.  Then it
decodes GPT-2 small token by token through ``Module(state_names=...)``
at batch 1 and 32 (float32, as ``benchmark/decode_bench.py``), holds the
decode against the teacher-forced LM and ``beam_search`` against greedy
decoding and a re-scoring, trains ViT-S/16 through ``Module`` on the
flash kernels (non-causal, bf16), and holds ``Module.predict`` of every
zoo network on the card against the CPU.  Then the Gluon path: the model
zoo's ResNet-50 v1 trains at ImageNet width through ``autograd.record()``
and ``gluon.Trainer``, hybridized with bf16 compute and imperatively,
with one float32 step held against the CPU, and a user attention block
at GPT-2 small's widths drives the flash kernels through the imperative
autograd.  Right after the build, a user kernel (the doubler,
``mxnet_tpu_torch/csrc/rtc_doubler.cu``) is compiled at runtime through
``mt.rtc.CudaModule`` and called on a 256 MiB NDArray.  Last, the RNN
family: ``benchmark/rnn_bench.py``'s LSTM language model (2 x 650,
vocab 10000, batch 64 x 35) trains through ``Module`` and
``FusedRNNCell`` in bf16, with one fp32 step held against the CPU;
``examples/rnn/train_ptb.py``'s ``BucketingModule.fit`` runs an epoch
at the same widths over four buckets; and a Gluon LSTM LM at those
widths trains through ``gluon.Trainer``, hybridized and imperatively,
with one fp32 step held against the CPU.  Then SSD-VGG16 trains and
detects.  Last, the rest of the Gluon model zoo (VGG-16, AlexNet,
SqueezeNet 1.1, DenseNet-121, MobileNet 1.0, Inception v3, at full width
and 1000 classes) trains through ``gluon.Trainer`` fed by
``gluon.data.DataLoader`` with worker threads, each network's fp32 step
is held against the CPU, the autoencoder, matrix-factorisation, DCGAN
and SVM examples' graphs train through ``Module`` on their loss heads,
and each newly ported dense op is held against the CPU.  Last, a
GShard-style mixture-of-experts LM at GPT-2 small's widths (8 experts in
every layer, top-2 gating, the chunked cross-entropy head) trains
through ``Module`` in bf16, its decode step is held against the
teacher-forced LM and one float32 step against the CPU, and the other
op families of that slice (linalg, sampling, the optimizer update ops,
CTC, a Custom op) run once each at a user's shape.  Last, the front
end: ResNet-50 trains at full width with LARS through ``Module.fit`` fed
by a ``PrefetchingIter`` that copies each batch to the card on a side
stream (no host sync inside ``Module.update``), is reshaped to batch 64
and scored, and its checkpoint is fine-tuned with the trunk fixed; then
every optimizer runs on ResNet-50's parameter shapes on the card and on
the CPU, and the new metrics, initializers, file iterators,
``FeedForward`` and ``SequentialModule`` are checked.  Last, data IO:
1024 seeded images of ImageNet's sizes are encoded on the card by nvJPEG
into a JPEG record file, the kernel I1 (``csrc/image_augment.cu``: resize,
crop, mirror, normalize) is held against its plain version, ResNet-50
trains by ``Module.fit`` from ``ImageRecordIter`` with
``train_imagenet.py``'s arguments (nvJPEG decode and I1 on the card), and
from raw records through ``ImageRecordUInt8Iter``, SSD-VGG16 trains from
``ImageDetRecordIter`` and detects, and ``ImageRecordDataset`` feeds a
``DataLoader``.  Then sparse storage and the single-process KVStore:
the sparse linear classifier and the two-tower recommender train from
row-sparse gradients, and ``Module.fit`` runs through a local store.
Last, checkpoints and observability: the GPT-2-small-width LM trains by
``Module.fit`` under ``do_checkpoint(sharded_async=True)`` and a
``Monitor``, resumes from the sharded checkpoint under the profiler,
equal bit for bit to an uninterrupted run, and its parameters go
through the reference MXNet's own ``.params`` format.  Last, the
distributed plane: the kernel Q1 (``csrc/grad_compress.cu``, 2-bit
quantization with error feedback) is held against its plain version,
the LM trains over ``dist_async`` from this process with two
parameter-server processes (started as ``tools/launch.py -s 2`` starts
them, their store and Adam on the host) and 2-bit pushes quantized by
Q1, its first step equal bit for bit to the servers' arithmetic replayed
here, and two worker processes train it cut to 2 layers over
``dist_sync`` (a gloo group), their weights bit-identical after every
step and close to one process on the concatenated batch (``--e1`` runs
these three phases alone).  Every phase prints one JSON line;
any failed phase exits non-zero.  The line before the last lists the
kernels with their launches on each path, times and bounds; the last
line is ``{"ok": true, "device": {...}}``.  Without CUDA, or without the
package beside it, it exits non-zero and prints no result.

Imports nothing of JAX and nothing of the JAX package.
"""
import contextlib
import json
import os
import subprocess
import sys
import tempfile
import threading
import time

import numpy as np

# GPT-2 small (Radford et al. 2019: n_layer 12, n_embd 768, n_head 12,
# n_ctx 1024) with the vocab rounded up to 50304, as in the repo's
# benchmark/transformer_bench.py
GPT2_SMALL = dict(vocab_size=50304, seq_len=1024, num_layers=12,
                  d_model=768, num_heads=12, d_ff=3072)
SEED = 0
BUCKETS = (1, 2, 4, 8)
REQUEST_ROWS = (1, 3, 2, 8, 5, 1)

# H100 SXM dense peaks (NVIDIA data sheet), at the full 700 W limit
PEAK_FLOPS = {"bfloat16": 989e12, "float32": 67e12}
PEAK_BYTES_PER_S = 3.35e12
# the largest bound share a measured time may show: the bound is the
# least time the card could take, so a share above 1 (5% for the
# rounding of the peak rates) means the measurement is wrong
BOUND_SHARE_MAX = 1.05

# tolerances, kernel vs plain version on the same inputs (both compute in
# f32; bf16 outputs may differ by the rounding of a near-tie, one bf16
# ulp is 2**-8 relative)
TOL = {"float32": dict(atol=1e-4, rtol=1e-4),
       "bfloat16": dict(atol=1e-2, rtol=1e-2)}
LSE_TOL = dict(atol=1e-4, rtol=1e-5)
# replies vs a direct predict of the same rows, in log-probability: the
# padded bucket and the direct one run the bf16 products at other row
# counts, so cuBLAS may pick other kernels that round differently
REPLY_LOGP_TOL = 0.1
# card (kernel, TF32 off) vs CPU (plain path), fp32, log-probability
FP32_LOGP_TOL = 1e-3
# backward kernels vs their plain version: both accumulate in f32 in
# another order; dK/dV sum up to Sq (x G) products of order 1, so f32
# gets 1e-3 on gradients of order 1-10, and a bf16 output one bf16
# rounding (2**-8 relative) after a near-tie on top
BWD_TOL = {"float32": dict(atol=1e-3, rtol=1e-3),
           "bfloat16": dict(atol=2e-2, rtol=2e-2)}

# training: the bench's initializer (benchmark/transformer_bench.py:91,
# Xavier gaussian, magnitude 2) with Adam, which at full width (4 layers,
# batch 1, fp32 on a CPU) falls smoothly over 15 steps where the bench's
# SGD + momentum 0.9 spikes; TRAIN_STEPS steps on one fixed seeded batch
# whose labels follow next = (3 * tok + 1) % V; the last loss must beat
# the first by TRAIN_MARGIN nats (fixed in advance, not fitted to a run)
TRAIN_BATCH = 8
TRAIN_STEPS = 15
TRAIN_LR = 3e-4
TRAIN_MARGIN = 2.0
# one fp32 Module step, card (kernels, TF32 off) vs CPU (plain path), at
# full width with 2 layers and batch 1 (cut so that the CPU side takes
# seconds): the loss within 1e-4 nats (a mean of 1024 f32 terms near
# 10.8), and each parameter's update within 1e-3 of that update's
# largest element (SGD lr 0.1: the update is the gradient, an f32 sum
# over up to 1024 tokens taken in another order on each side)
FP32_TRAIN_LAYERS = 2
FP32_TRAIN_LR = 0.1
FP32_LOSS_TOL = 1e-4
FP32_UPDATE_RTOL = 1e-3

# ResNet-50 training, the JAX package's bench.py recipe (bench.py:82-99,
# 353-371): ResNet-50 v2, 224x224x3, 1000 classes, stem conv7, NCHW,
# batch 256, bf16 compute over fp32 masters, Xavier gaussian magnitude 2,
# SGD lr 0.1 momentum 0.9 wd 1e-4, two synthetic batches made on the card
# and taken in turn (bench.py:379-389), 5 warm-up steps (bench.py:115)
RESNET = dict(num_layers=50, num_classes=1000, image_shape="3,224,224")
RESNET_BATCH = 256
RESNET_OPT = {"learning_rate": 0.1, "momentum": 0.9, "wd": 1e-4}
RESNET_WARMUP = 5
RESNET_STEPS = 20
# the mean loss of the last 5 of the 25 steps must beat the mean of the
# first 5 by this many nats, fixed before the first run on the card from
# a CPU rehearsal of the same loop (ResNet-50 at full depth and width,
# batch 32 of 64x64 or batch 16 of 112x112, fp32 and bf16, two seeds):
# there the first 5 averaged 5.4-5.9 and the last 5 under 0.01, a drop
# of 5.3 nats or more.  At batch 256 each batch holds 8-16x more random
# labels to fit in the same 12 passes, so the margin is a fifth of the
# smallest rehearsed drop
RESNET_MARGIN = 1.0
# analytic FLOPs of one step, bench.py:495 (copied): ResNet-50 is about
# 4.1e9 multiply-adds a 224x224 image forward, training about 3x that
RESNET_FWD_MACS = 4.1e9
# one fp32 SGD-momentum step at full depth and width, card (TF32 off)
# against the CPU from the same numpy weights; cut: batch 4 of 128x128
# images (the last stage still normalises over 4 x 4 x 4 = 64 values a
# channel), so that the CPU side takes seconds.  The forward is held
# tightly: the loss within 1e-4 nats, each moving statistic within 1e-4
# of its largest element.  The backward of this network at this point is
# ill-conditioned: on the CPU, fp32 against float64 moves the gradient by
# 1.0e-2 of its norm and single parameters by up to 14% of their largest
# element (tests/torch_numerics.py resnet prints it,
# tests/test_torch_resnet.py::test_resnet50_fp32_gradient_against_float64
# bounds it), so no fp32 pair can meet
# 1e-3 per parameter.  So: fc1's update (its gradient passes no
# BatchNorm) within 1e-3 of its largest element, and the whole update
# within 5e-2 of its norm (two fp32 errors of 1e-2 each, 3x margin; a
# wrong backward moves it by O(1))
RESNET_FP32_BATCH = 4
RESNET_FP32_IMAGE = (3, 128, 128)
RESNET_FP32_LOSS_TOL = 1e-4
RESNET_FP32_AUX_RTOL = 1e-4
RESNET_FP32_HEAD_RTOL = 1e-3
RESNET_FP32_UPDATE_NORM_RTOL = 5e-2
# Module.fit for one epoch of a few synthetic batches (as
# examples/image_classification/train_imagenet.py's SyntheticIter), then
# a checkpoint that must reload bit for bit
FIT_BATCH = 32
FIT_BATCHES = 4

# KV-cache decode, benchmark/decode_bench.py's configuration: GPT-2 small
# (the weights of GPT2_SMALL), max_len 1024, float32 with TF32 off, one
# token a row a step through Module(state_names=...), batch 1 and 32,
# DECODE_WARMUP steps, then DECODE_STEPS timed with one readback at the end
DECODE_BATCHES = (1, 32)
DECODE_WARMUP = 3
DECODE_STEPS = 64
# the decode's log-softmax against the teacher-forced LM's (seq 1024, K1's
# fp32 kernel) at each of the first DECODE_STEPS positions: the CPU
# rehearsal at full width and 2 layers (tests/torch_numerics.py
# decode_vs_lm) gave 3.2e-6; the card runs 6x the depth and K1 sums in
# another order than the decode's batch_dot + softmax, so 30x that
DECODE_LOGP_TOL = 1e-4
# beam search: 4 prompts x beam 4 (batch 16), 32 tokens; each returned
# score (sum of 32 log-probabilities / 32) against the teacher-forced LM's
# re-scoring of its sequence: the CPU rehearsal (2 layers) gave 9.5e-7;
# 100x that for depth and the card's reduction orders
BEAM_PROMPTS = (11, 2024, 31337, 50000)
BEAM_SIZE = 4
BEAM_GEN = 32
BEAM_SCORE_TOL = 1e-4

# ViT-S/16 training: models.vit(1000)'s defaults are DeiT-S's widths
# (Touvron et al. 2021, Table 1: d 384, 6 heads, 12 layers, patch 16,
# 224x224, 196 tokens) with an average-pool head in place of the class
# token; through Module, bf16 over fp32 masters, batch 128 (DeiT's 1024
# over 8 GPUs), Adam lr 5e-4, Xavier gaussian magnitude 2, two synthetic
# batches made on the card taken in turn
VIT_BATCH = 128
VIT_LR = 5e-4
VIT_WARMUP = 5
VIT_STEPS = 20
VIT_LAYERS = 12
# analytic FLOPs of one image's forward: the patch embedding, and per
# layer the qkv, proj, fc1 and fc2 products plus the scores and P.V over
# 196 tokens, 2 FLOPs a multiply-add (9.14 GFLOP; DeiT-S's 4.6 G
# multiply-adds); a training step is 3x the forward
VIT_FWD_FLOPS = 2.0 * (196 * 768 * 384 + VIT_LAYERS * (
    196 * 384 * (3 * 384 + 384 + 2 * 4 * 384) + 2 * 196 * 196 * 384)
    + 384 * 1000)
# the mean loss of the last 5 of the 25 steps must beat the first 5's by
# this many nats, fixed before the first card run from the CPU rehearsal
# (tests/torch_numerics.py vit: full depth and width, batch 16, the
# same recipe): there the first 5 averaged 4.53 and the last 5 0.008 in
# fp32 (bf16 followed the same losses for the 12 steps run), a drop of
# 4.52 nats (5.05 with this phase's own two batches, rehearsed again
# later).  At batch 128 each batch holds 8x more random labels to fit in
# the same 12 passes, so the margin is a fifth of the first drop, as
# RESNET_MARGIN's
VIT_MARGIN = 0.9

# Module.predict of every zoo network at its published input (mlp and
# lenet 1x28x28, inception-v3 299x299, the rest 224x224), batch 2 over 3
# images (the last batch padded by one), fp32 with the seeded He-scaled
# weights: the card (cuDNN, TF32 off) against the CPU, in probability
ZOO = (("mlp", dict(num_classes=10), (1, 28, 28)),
       ("lenet", dict(num_classes=10), (1, 28, 28)),
       ("resnet", dict(num_layers=50, image_shape="3,224,224"),
        (3, 224, 224)),
       ("resnext", dict(num_layers=50), (3, 224, 224)),
       ("inception-bn", {}, (3, 224, 224)),
       ("inception-v3", {}, (3, 299, 299)),
       ("mobilenet", {}, (3, 224, 224)),
       ("densenet", dict(num_layers=121), (3, 224, 224)),
       ("alexnet", {}, (3, 224, 224)),
       ("vgg", dict(num_layers=16), (3, 224, 224)),
       ("squeezenet", {}, (3, 224, 224)),
       ("vit", {}, (3, 224, 224)))
ZOO_DROPOUT = ("alexnet", "vgg", "squeezenet")
# the logits (the SoftmaxOutput's input) are compared, relative to
# their spread (largest minus smallest): random He-scaled weights
# saturate resnet's and resnext's softmax, where probabilities would
# hide the logits.  The CPU rehearsal (tests/torch_numerics.py zoo) put
# each f32 order (oneDNN's convolutions, the plain ones) at most 5.6e-7
# of the spread from a float64 run (vgg); the card's cuDNN is a third
# order and the check sees two, so 1e-5 is 9x their sum
ZOO_LOGIT_TOL = 1e-5
# the network's probabilities on the card against numpy's softmax of the
# card's logits: the same logits, the softmax evaluated in two places in
# f32, a few ulps of 1.0
ZOO_SOFTMAX_TOL = 1e-6

# Gluon ResNet-50 v1 training: the model zoo's resnet50_v1
# (mxnet_tpu/gluon/model_zoo/vision/resnet.py:274, He et al. 2015 Table
# 1) at ImageNet width, 1000 classes, batch 256 of 224x224 as bench.py,
# through autograd.record() -> net -> SoftmaxCrossEntropyLoss ->
# backward() -> gluon.Trainer.step(256): SGD lr 0.1 momentum 0.9 wd
# 1e-4, Xavier gaussian magnitude 2, two synthetic batches made on the
# card from a seed (int32 labels) taken in turn.  Hybridized with
# compute_dtype="bfloat16" (the JAX package's Gluon bf16 recipe, bf16
# compute over fp32 masters), 5 warm-up and 40 timed steps; then the same
# net imperatively (not hybridized), 5 + 10 steps
GLUON_BATCH = 256
GLUON_OPT = {"learning_rate": 0.1, "momentum": 0.9, "wd": 1e-4}
GLUON_WARMUP = 5
GLUON_STEPS = 40
GLUON_IMP_WARMUP = 5
GLUON_IMP_STEPS = 10
# the mean loss of the last 5 of the 45 steps must beat the first 5's by
# this many nats, fixed before the first card run from CPU rehearsals of
# the same loop in fp32 (resnet50_v1 at full depth and width; the first
# by tests/torch_numerics.py gluon): the drop was 23.05 nats at batch 16
# of 112x112, 6.67 at batch 32 of 112x112, 5.75 and 4.18 at batch 64 of
# 64x64 (two seeds), most of it a spike of the first steps (lr 0.1 with
# no warm-up) that shrinks as the batch grows, the last 5 averaging
# 6.3-6.9.  The margin is a fifth of the smallest drop, as RESNET_MARGIN's.
# At batch 256 on the card the spike is small and the loss stays near
# ln 1000 on the two batches of random labels until memorisation starts,
# at a step that cuDNN's nondeterminism moves: the phase ran 25 steps
# until a card run fell 0.50 short; tools/gluon_loss_runs.py (8 runs of
# 60 steps, H100) read drops of 0.46-3.10 at 25 steps and 6.82-7.19 at
# 45, so the phase runs 45 and keeps the margin
GLUON_MARGIN = 0.8
# one fp32 step of resnet50_v1 at batch 2 of 224x224 (full depth and
# width), card (TF32 off) against the CPU from the same seeded weights,
# hybridized and imperatively, with resnet_fp32_card_vs_cpu's budget: the
# loss within 1e-4, each running statistic within 1e-4 of its largest
# element, the output layer's gradient and update (they pass no
# BatchNorm) within 1e-3 of their largest element, and the whole gradient
# and update within 5e-2 of their norm (tests/torch_numerics.py gluon
# prints the CPU's fp32 distance from float64 behind it)
GLUON_FP32_BATCH = 2
GLUON_FP32_IMAGE = (3, 224, 224)
GLUON_FP32_LOSS_TOL = 1e-4
GLUON_FP32_AUX_RTOL = 1e-4
GLUON_FP32_HEAD_RTOL = 1e-3
GLUON_FP32_NORM_RTOL = 5e-2
# the attention block: a user HybridBlock at GPT-2 small's widths (d 768,
# 12 heads of 64, S 1024, batch 8, causal): Dense(3d) -> (B, H, S, D) ->
# F.contrib.FlashAttention -> (B, S, d) -> Dense(d), under record() with
# backward() and one Trainer step (SGD lr 0.1) a run, imperatively and
# hybridized, in bf16 (hybridize(compute_dtype="bfloat16"); imperatively
# net.cast("bfloat16") with bf16 inputs); and once in fp32 at batch 2
# against the CPU (TF32 off): the output and the input gradient within
# 1e-3 of their largest element, and every parameter's update within
# 1e-3 of the block's largest update (K1-K3 against the plain attention,
# as kernel_check's fp32 rows, plus the two Dense products summing
# 768-2304 terms in another order).  Not of each parameter's own largest
# update: a weight's gradient sums over 2048 tokens products of the loss
# gradient with the inputs, which cancel, so the CPU's own fp32 lands
# 2.9e-3 of the qkv weight's own largest update from float64, 2.3e-4 of
# the block's (tests/torch_numerics.py gluon, attention_fp32_vs_float64;
# the first card run showed the same 2.9e-3 card vs CPU while the output
# and the input gradient agreed to 1.3e-6)
ATTN_D, ATTN_HEADS, ATTN_SEQ, ATTN_BATCH = 768, 12, 1024, 8
ATTN_STEPS = 3
ATTN_FP32_BATCH = 2
ATTN_FP32_RTOL = 1e-3
# the user-kernel path (mx.rtc): the doubler of tests/test_contrib.py:100
# (o = 2 x, a Pallas kernel there) as CUDA source, compiled at runtime
# through rtc.CudaModule and called through rtc.CudaFunction on an
# (8192, 8192) f32 NDArray (256 MiB), bit for bit against x * 2; its
# bound is one read and one write of 256 MiB at 3.35 TB/s
RTC_SOURCE = os.path.join("mxnet_tpu_torch", "csrc", "rtc_doubler.cu")
RTC_SHAPE = (8192, 8192)
RTC_BLOCK = 256
# the vectorised doubler's grid: each thread takes four float4 vectors,
# all in flight in one round of its loop (a launch sweep on the card,
# PERF.md §6: one to 16 vectors a thread ran 0.182-0.187 ms, a grid of 2
# to 64 blocks an SM, each thread looping over many, 0.19-0.20 ms)
RTC_VECTORS_PER_THREAD = 4
# the LSTM language model of benchmark/rnn_bench.py:39-63,88-99 (Zaremba
# et al. 2014's medium PTB model: 2 layers of 650, embedding 650,
# unrolled 35 steps; vocab 10000, batch 64), not cut: FusedRNNCell
# (the fused RNN op, cuDNN), bf16 compute over fp32 masters, Xavier, SGD
# momentum 0.9 at lr 0.3 (rnn_bench.py's lr 1.0, without the gradient
# clipping of Zaremba et al., makes the loss alternate between the two
# batches: 9.59 -> 9.44 over 25 steps in the CPU rehearsal, where lr 0.3
# gives 9.18 -> 8.28; the step's work is the same), int32 ids and labels (rnn_bench.py feeds float
# ids, which a bf16 cast rounds above 256), two synthetic batches made
# on the card (rnn_batches); RNN_WARMUP + RNN_STEPS steps
RNN = dict(layers=2, hidden=650, embed=650, seq=35, vocab=10000, batch=64)
RNN_OPT = {"learning_rate": 0.3, "momentum": 0.9}
RNN_WARMUP = 5
RNN_STEPS = 20
# analytic fwd + bwd FLOPs a token, rnn_bench.py:137-149 (copied): the
# 4-gate input and hidden products of each layer and the vocab
# projection, x 3 for the backward (the embedding is a gather)
RNN_FLOPS_PER_TOKEN = 3.0 * (sum(
    2.0 * 4 * RNN["hidden"] * ((RNN["embed"] if l == 0 else RNN["hidden"])
                               + RNN["hidden"])
    for l in range(RNN["layers"])) + 2.0 * RNN["hidden"] * RNN["vocab"])
# the mean of the last 5 losses must be below the first 5's by this many
# nats (fixed from tests/torch_numerics.py rnn, the same loop in fp32 on
# the CPU: about a third of its drop)
RNN_MARGIN = 0.3
# one fp32 step of the same model and batch, card (TF32 off) against the
# CPU from the same numpy weights: the loss, and each parameter's update
# relative to its own largest element (tests/torch_numerics.py rnn: the
# CPU's fp32 lands 2.6e-7 from float64 in the loss and 1.0e-6 in the
# updates; the card's cuDNN is a second f32 order, and the budgets are
# about 40x and 100x that)
RNN_FP32_LOSS_TOL = 1e-5
RNN_FP32_UPDATE_RTOL = 1e-4
# examples/rnn/train_ptb.py's path (:58-110) at PTB-medium widths: 2
# LSTMCells of 650 in a SequentialRNNCell (unfused), embedding 650,
# vocab 10000 (the embedding and the softmax), BucketSentenceIter over
# 3000 sentences of the example's synthetic_corpus (copied below) at
# its own default of 60 token ids (with 10000, one epoch sees each id
# about 5 times and the CPU rehearsal's perplexity stays flat or rises
# at lr 0.01-1.0: PERF.md §6; its sentences are 8-24 tokens, so
# bucket 40, the default, is bound and gets no batch), buckets
# 10/20/30/40, batch 32,
# BucketingModule.fit for one epoch with Perplexity (the pad label left
# out), bf16, the example's SGD (lr 0.1, examples/common.py's momentum
# 0.9 and wd 1e-4) and Xavier
PTB = dict(layers=2, hidden=650, embed=650, vocab=10000, batch=32,
           buckets=(10, 20, 30, 40), sentences=3000, corpus_vocab=60)
PTB_OPT = {"learning_rate": 0.1, "momentum": 0.9, "wd": 1e-4}
# the mean log-perplexity of the last PTB_WINDOW batches must be below
# the first PTB_WINDOW's by PTB_MARGIN nats (tests/torch_numerics.py
# rnn, fp32 on the CPU: 8.32 -> 3.74 over 92 batches, so a third of it)
PTB_WINDOW = 10
PTB_MARGIN = 1.5
# the Gluon LM at rnn_train's widths and batches: nn.Embedding ->
# gluon.rnn.LSTM(650, 2) -> nn.Dense(10000),
# SoftmaxCrossEntropyLoss(weight=35) (Gluon's loss is the mean over the
# sequence; the weight makes it the sum that Module's SoftmaxOutput
# differentiates, so rnn_train's SGD takes the same step; losses are
# reported a token), gluon.Trainer; hybridized
# (compute_dtype="bfloat16") and imperatively (net.cast("bfloat16"),
# multi_precision), GLUON_LM_WARMUP + GLUON_LM_STEPS steps a path; one
# fp32 step at batch GLUON_LM_FP32_BATCH card against CPU
GLUON_LM_OPT = dict(RNN_OPT)
GLUON_LM_WARMUP = 5
GLUON_LM_STEPS = 10
# the mean of the last 3 losses below the first 3's by this many nats
# (tests/torch_numerics.py rnn: 9.21 -> 8.67, a third of it)
GLUON_LM_MARGIN = 0.18
# (tests/torch_numerics.py rnn: the CPU's fp32 lands 5.1e-7 from
# float64 in the loss, and 1.5e-4 of their own largest element in the
# h2h weights' updates, which cancel over 8 x 35 products; 1e-5 and 2e-3)
GLUON_LM_FP32_BATCH = 8
GLUON_LM_FP32_LOSS_TOL = 1e-5
GLUON_LM_FP32_UPDATE_RTOL = 2e-3

# SSD-300 with the VGG16-reduced backbone (mxnet_tpu/models/ssd.py
# ssd_vgg16, BASELINE config 5) at its published width: 20 VOC classes,
# 3x300x300, batch 32 (Liu et al. 2016, "SSD: Single Shot MultiBox
# Detector", section 3), at most 16 objects an image, bf16 compute over
# fp32 masters, examples/ssd/train_ssd.py's optimizer (SGD momentum 0.9,
# lr 0.004, wd 5e-4, clip_gradient 4.0, lines 48-49 and 76-80) with
# rescale_grad 1.0 as the reference's example/ssd/train/train_net.py sets
# it (both loss heads already divide by their valid counts; Module's
# default of 1/batch, which train_ssd.py leaves, divides the step by the
# batch once more), and bench.py's Xavier (gaussian, magnitude 2) where
# train_ssd.py has Xavier's default: the reference starts from pretrained
# VGG16 weights, which the repo does not hold, and from scratch the
# default's variance (1/fan) halves through each of the backbone's 15
# ReLU convolutions, so the heads start at a uniform softmax.  CPU
# rehearsal at batch 4 (tests/torch_numerics.py ssd): the mean of the last
# 5 of 25 losses 0.006 below the first 5's with train_ssd.py's settings,
# 0.023 with rescale_grad 1.0, 0.134 with both changes.
# train_ssd.py's synthetic images (1-4 filled rectangles, each in the
# intensity of its class, on noise) scaled to 20 classes, two batches
# made on the card (ssd_batches) and taken in turn
SSD = dict(num_classes=20, size=300, batch=32, max_objects=16)
SSD_OPT = {"learning_rate": 0.004, "momentum": 0.9, "wd": 5e-4,
           "clip_gradient": 4.0, "rescale_grad": 1.0}
SSD_WARMUP = 5
SSD_STEPS = 20
SSD_INIT = dict(rnd_type="gaussian", magnitude=2.0)

# the mean of the last 5 total losses (softmax cross-entropy over the
# mined anchors + smooth-L1 a positive anchor) must beat the first 5's by
# SSD_MARGIN, fixed from the CPU rehearsal (tests/torch_numerics.py ssd:
# fp32, batch 4, the CPU's own batches: 5.932 -> 5.798, a drop of 0.134)
# at about a third of it, since the card runs bf16 at batch 32 (the
# per-anchor normalised step is about the same)
SSD_MARGIN = 0.05
# one fp32 step at batch 2, card (TF32 off) against the CPU from the same
# parameters and batch (tests/torch_numerics.py ssd gives the fp32 step's
# distance from float64):
# - MultiBoxTarget's outputs equal, but for anchors at the mining cut
#   whose background probabilities lie within SSD_TIE_RTOL of the cut on
#   both sides (the convolutions round in another order on each side);
#   the loc targets within SSD_LOC_ULPS f32 ulps (log rounds the last
#   bit on its own on each side)
# - the loss and each parameter's update (relative to its largest
#   element) within SSD_FP32_LOSS_TOL and SSD_FP32_UPDATE_RTOL
SSD_FP32_BATCH = 2
SSD_TIE_RTOL = 1e-4
SSD_LOC_ULPS = 2
# (the CPU's fp32 against float64: loss 9.0e-7, updates 2.4e-3 of their
# largest element, in stage5_conv3_bias; the card's own error adds one
# of the same order: budgets 1e-5 and 1e-2)
SSD_FP32_LOSS_TOL = 1e-5
SSD_FP32_UPDATE_RTOL = 1e-2
# detection: mode="detect" through Module.predict at batch 32 (bf16
# compute), MultiBoxDetection's defaults (threshold 0.01, NMS 0.5, all
# 8108 boxes); the check holds two images' detections card against CPU
# and both against a numpy greedy NMS
SSD_DETECT_IMAGES = 2
# card against CPU on the same f32 inputs: the decoded boxes and scores
# within 1e-6 (exp rounds its last bit on its own on each side; the
# values lie in [0, 1]), the ids equal
SSD_DETECT_TOL = 1e-6
# the NMS suppression-matrix kernel (csrc/nms_overlap.cu) against its
# plain version, bit for bit, at the shapes of one launch: the detect
# path's (4 images x 8108 boxes, the chunk nms_keep hands it at
# NMS_CHUNK_ELEMENTS, eight a batch of 32; per class; bf16 as the bf16
# graph hands it, and f32) and Proposal's default (one image,
# rpn_pre_nms_top_n 6000 pixel boxes, every box suppressing, threshold
# 0.7); boxes in clusters so that many pairs lie near the threshold, a
# share of them invalid; and, untimed, the kernel's edges: a single box,
# and every box invalid (rows stored as zeros without a load)
NMS_CASES = {
    # images, boxes, dtype, rule, threshold, classes, invalid share
    "detect_bf16": (4, 8108, "bfloat16", "corner", 0.5, True, 0.05),
    "detect_fp32": (4, 8108, "float32", "corner", 0.5, True, 0.05),
    "proposal_fp32": (1, 6000, "float32", "pixel", 0.7, False, 0.05),
    "single_box": (1, 1, "float32", "corner", 0.5, True, 0.0),
    "all_invalid_bf16": (4, 8108, "bfloat16", "corner", 0.5, True, 1.0),
}
NMS_TIMED = ("detect_bf16", "detect_fp32", "proposal_fp32")
# operations a candidate pair (j < i, j valid, one class): the IoU's
# min / max / subtract / multiply / add / divide and the comparisons
NMS_OPS_PER_PAIR = 20


T0 = time.monotonic()


def emit(phase, **kw):
    print(json.dumps({"phase": phase, "t_s": time.monotonic() - T0, **kw}),
          flush=True)


def time_ms(fn, iters=20, repeats=5, warmup=3):
    """(median, min, max) over ``repeats`` timed loops of the mean ms per
    call of ``iters`` calls, by CUDA events."""
    import torch
    for _ in range(warmup):
        fn()
    torch.cuda.synchronize()
    start = torch.cuda.Event(enable_timing=True)
    end = torch.cuda.Event(enable_timing=True)
    times = []
    for _ in range(repeats):
        start.record()
        for _ in range(iters):
            fn()
        end.record()
        end.synchronize()
        times.append(start.elapsed_time(end) / iters)
    return float(np.median(times)), min(times), max(times)


# host sleep at each end of a profiled window: torch.profiler keeps only
# the kernels whose times, mapped to the host's clock, fall inside the
# window, and on the H100 machine that mapping wandered by up to 5.5 ms
# from one window to the next (tools/profiler_window_probe.py: 2 of 42
# windows that launched at once after opening lost 1 and 8 kernels of 20;
# none of 42 padded by 50 ms lost one)
PROFILE_PAD_S = 0.05


@contextlib.contextmanager
def device_window(torch, cpu=True):
    """torch.profiler over the card's kernels (and the host's ops with
    ``cpu``), the body between ``PROFILE_PAD_S`` of host sleep at each
    end so that no kernel falls outside the window; yields the profile."""
    from torch.profiler import ProfilerActivity, profile
    acts = [ProfilerActivity.CPU] * cpu + [ProfilerActivity.CUDA]
    with profile(activities=acts) as prof:
        time.sleep(PROFILE_PAD_S)
        yield prof
        torch.cuda.synchronize()
        time.sleep(PROFILE_PAD_S)


def device_ms(torch, fn, iters=20, stem="", per_call=None):
    """(mean device ms a call of ``fn``, the kernels' names): the kernels
    the card ran over ``iters`` calls under torch.profiler (after one
    synchronised warm-up call), those whose names hold ``stem`` alone
    where it is given, summed.  A window counts only when it holds every
    launch: ``per_call`` matching launches a call (default 1 with a
    ``stem``), or without a stem a whole number of launches a call, at
    least one.  A window that caught fewer (the first window of a
    process may record no device activity; an unpadded window lost
    kernels at its edges, see ``PROFILE_PAD_S``) is taken again, twice
    at most; then the call fails."""
    if per_call is None and stem:
        per_call = 1
    fn()
    torch.cuda.synchronize()
    seen = []
    for _ in range(3):
        with device_window(torch, cpu=False) as prof:
            for _ in range(iters):
                fn()
            torch.cuda.synchronize()
        kernels = [r for r in device_kernels(prof) if stem in r[2]]
        n = sum(c for _, c, _ in kernels)
        whole = (n == per_call * iters if per_call
                 else n >= iters and n % iters == 0)
        if whole:
            return sum(ms for ms, _, _ in kernels) / iters, [
                k for _, _, k in kernels]
        seen.append(n)
        print(f"device_ms: a window held {n} launches of "
              f"{stem or 'any kernel'} over {iters} calls; taken again",
              file=sys.stderr, flush=True)
    raise RuntimeError(
        f"device_ms: torch.profiler's windows held {seen} launches of "
        f"{stem or 'any kernel'}, want {per_call or 'a whole number'} a "
        f"call over {iters} calls")


def check_bound_share(row, ms_key, fails, name):
    """``row["bound_share"]``: the bound over the measured time; above
    1.05 no card can be, so the time is wrong: a failure of the phase."""
    row["bound_share"] = row["bound_ms"] / row[ms_key]
    if row["bound_share"] > BOUND_SHARE_MAX:
        fails.append(f"{name}: {ms_key} {row[ms_key]} ms is under the "
                     f"bound {row['bound_ms']} ms (share "
                     f"{row['bound_share']:.3f} > {BOUND_SHARE_MAX})")


def host_ms(torch, fn, iters=50):
    """Mean host ms before a call of ``fn`` returns (no synchronise inside
    the loop: what the host spends to enqueue it), after a synchronised
    warm-up call."""
    fn()
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    for _ in range(iters):
        fn()
    ms = (time.perf_counter() - t0) / iters * 1e3
    torch.cuda.synchronize()
    return ms


def timed(row, key, fn, **kw):
    """``row[key]``: the median ms of ``fn`` (:func:`time_ms`), with its
    min and max under ``key_min`` and ``key_max``."""
    med, lo, hi = time_ms(fn, **kw)
    row.update({key: med, f"{key}_min": lo, f"{key}_max": hi})


def attention_bound_ms(B, H, Hk, Sq, Sk, D, causal, dtype, kind="fwd",
                       lse=False):
    """Least time for one attention kernel on an H100 SXM: each input
    read once and each output written once over the memory rate, against
    the products these inputs need (causal: only the k <= q pairs) over
    the peak rate for the inputs' type.  ``kind``: ``fwd`` (K1: q, k, v
    in, o out, and the f32 lse with ``lse``; s and P.V), ``dq`` (K2: q,
    k, v, dO, lse, delta in, dQ out; s, dP and dS.K) or ``dkv`` (K3: q,
    k, v, dO, lse, delta in, dK, dV out; s, dP, P^T.dO and dS^T.Q)."""
    esize = 2 if dtype == "bfloat16" else 4
    q_el, kv_el, rows = B * H * Sq * D, B * Hk * Sk * D, B * H * Sq
    nbytes, products = {
        "fwd": (esize * (2 * q_el + 2 * kv_el) + (4 * rows if lse else 0),
                2),
        "dq": (esize * (3 * q_el + 2 * kv_el) + 4 * 2 * rows, 3),
        "dkv": (esize * (2 * q_el + 4 * kv_el) + 4 * 2 * rows, 4),
    }[kind]
    if causal:
        pairs = sum(min(q + 1, Sk) for q in range(Sq))
    else:
        pairs = Sq * Sk
    flops = 2.0 * products * B * H * D * pairs
    t_bytes = nbytes / PEAK_BYTES_PER_S * 1e3
    t_ops = flops / PEAK_FLOPS[dtype] * 1e3
    return max(t_bytes, t_ops), ("bytes" if t_bytes >= t_ops
                                 else "operations"), flops, nbytes


def phase_device(torch):
    smi = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit",
         "--format=csv,noheader"], capture_output=True, text=True,
        timeout=60)
    line = smi.stdout.strip().splitlines()[0] if smi.stdout.strip() else ""
    if smi.returncode != 0 or not line:
        raise RuntimeError(f"nvidia-smi failed: {smi.stderr.strip()}")
    print(line, flush=True)
    emit("device", nvidia_smi=line, torch=torch.__version__,
         cuda=torch.version.cuda, python=sys.version.split()[0],
         name=torch.cuda.get_device_name(0),
         count=torch.cuda.device_count())
    return line


# the kernel-check rows that are timed: the main paths' shapes
TIMED_CASES = ("main_bf16", "main_fp32", "vit_bf16", "vit_fp32")

# the f32 K2 and K3 (CUDA cores) as the kernels line describes them
F32_BWD_DESIGN = {
    "dq": "CUDA cores, full f32: 128 threads, each computing S and dP for "
          "one 4x8 patch from float4 reads of rows strided D + 4, dS in "
          "registers, then dQ += dS.K in 8x4 patches through shared "
          "memory; K through a two-stage 16-byte cp.async ring, V's next "
          "tile copied once S and dP are done; exp as exp2f; heaviest "
          "causal q tiles first",
    "dkv": "CUDA cores, full f32: 128 threads, 64 k rows a block, 64-row q "
           "tiles with lse and delta copied by 16-byte cp.async; each "
           "thread computes S^T and dP^T for one 4x8 patch, P^T and dS^T "
           "through shared memory, then warps 0-1 add dV and warps 2-3 dK "
           "in 8 x D/8 patches, summed over the GQA group in registers; "
           "exp as exp2f",
}

# K1's f32 instance and N1 as the kernels line describes them
F32_FWD_DESIGN = (
    "CUDA cores, full f32: 4 warps a block, each warp 16 q rows of a "
    "64-row q tile, or (when 64-row tiles leave SMs without a block) all "
    "four on one 16-row tile, each taking a quarter of every key tile "
    "with its own softmax state, merged at the end; each lane S for a "
    "4x8 (4x2) patch from float4 reads of rows strided D + 4, online "
    "softmax in base 2 (exp2f) with the row max by shuffles, P through "
    "the warp's own shared tile (__syncwarp), O += P.V in 4 x D/8 "
    "patches; K and V through a two-stage 16-byte cp.async ring, one "
    "barrier a tile; masks only on the diagonal and the ragged tile; "
    "heaviest causal q tiles first")
NMS_DESIGN = (
    "16 consecutive i's a thread, one 16-byte store a row (rows padded to "
    "16 bytes), 128 threads x 2048 i's x 16 rows j a block; the i's "
    "classes in registers, their boxes (bf16 as their own 8 bytes) and "
    "areas staged once in shared memory; the order, range and class "
    "tests as a 16-bit mask before any IoU; a warp-row with 128 "
    "candidates or more takes all 16 IoUs a lane, fewer are listed and "
    "shared out across the warp 32 at a time; the rounded IoU decided "
    "against exact bounds without dividing; invalid rows and the lower "
    "triangle stored as zeros without an IoU; the plain version's "
    "rounding")

# the kernels on the tensor cores (the bf16 instances of K1, K2 and K3):
# each instance must hold HMMA instructions, and the D=64 ones (the main
# paths') must not spill
MMA_KERNELS = ("flash_fwd_mma_kernel", "flash_bwd_dq_mma_kernel",
               "flash_bwd_dkv_mma_kernel")
# the float32 instances of K1, K2 and K3, full f32 on the CUDA cores, with
# their count of instances: each must hold no HMMA instruction (no TF32
# product), and the D=64 ones must not spill; K1's f32 kernel has two
# instances a head dim (32, 64, 128), its warps owning the rows of a
# 64-row q tile or splitting the keys of a 16-row one, K2's and K3's one
# a head dim
F32_KERNELS = {"flash_fwd_kernel": 6, "flash_bwd_dq_kernel": 3,
               "flash_bwd_dkv_kernel": 3}


def demangle(names, nvcc_dir):
    """Readable kernel names (``cu++filt`` beside nvcc), e.g.
    ``flash_fwd_mma_kernel<64>``; the mangled names where it is missing."""
    names = list(names)
    tool = os.path.join(nvcc_dir, "cu++filt")
    if not names or not os.access(tool, os.X_OK):
        return dict(zip(names, names))
    res = subprocess.run([tool], input="\n".join(names), capture_output=True,
                         text=True, timeout=60)
    # "void <unnamed>::flash_fwd_mma_kernel<(int)64>(...)", or with
    # "(anonymous namespace)::"; a bool argument as "(bool)0"
    short = [d.replace("(int)", "").replace("(bool)0", "false")
             .replace("(bool)1", "true").replace("(anonymous namespace)", "")
             .split("(")[0].split("::")[-1] for d in res.stdout.splitlines()]
    if res.returncode != 0 or len(set(short)) != len(names):
        return dict(zip(names, names))
    return dict(zip(names, short))


def phase_build(mt):
    """Build every source at once; per kernel, the registers and spills
    that ``-Xptxas -v`` reports and the HMMA (tensor-core product) count
    of its machine code (``cuobjdump -sass``).  The tensor-core kernels
    must hold HMMA, the f32 K1, K2 and K3 none; each has its instances
    (``F32_KERNELS``; three, D 32, 64, 128, for the tensor-core ones),
    and none spills at D=64."""
    cl = mt.cuda_lib
    t0 = time.monotonic()
    built = cl.build_all()
    secs = time.monotonic() - t0
    kernels, failures = {}, []
    for src, info in built.items():
        if src in cl.SHIMS:        # no kernel of its own (nvJPEG's shim)
            continue
        log = info["log"]
        if not log and os.path.exists(info["path"] + ".log"):
            with open(info["path"] + ".log") as f:
                log = f.read()
        report = cl.ptxas_report(log)
        hmma = cl.hmma_counts(cl.disassemble(info["path"]))
        names = demangle(sorted(set(report) | set(hmma)),
                         os.path.dirname(cl.find_nvcc()))
        for mangled, name in names.items():
            row = dict(report.get(mangled, {}), hmma=hmma.get(mangled, 0),
                       source=src)
            kernels[name] = row
            mma = any(stem in mangled for stem in MMA_KERNELS)
            if not mma and not any(stem in mangled for stem in F32_KERNELS):
                continue
            if mma and row["hmma"] == 0:
                failures.append(f"{name}: no HMMA instruction")
            if not mma and row["hmma"]:
                failures.append(f"{name}: {row['hmma']} HMMA instructions "
                                "in an f32 kernel")
            if "ILi64E" in mangled and (row.get("spill_stores", 1)
                                        or row.get("spill_loads", 1)):
                failures.append(f"{name}: spills {row}")
    want = dict(F32_KERNELS, **{stem: 3 for stem in MMA_KERNELS},
                image_augment_kernel=3, relu_grad_kernel=4,
                quantize_2bit_kernel=2)
    for name, row in kernels.items():
        if any(stem in name for stem in ("image_augment_kernel",
                                         "relu_grad_kernel",
                                         "quantize_2bit_kernel")) \
                and (row.get("spill_stores", 1) or row.get("spill_loads", 1)):
            failures.append(f"{name}: spills {row}")
    for stem, count in want.items():
        if sum(stem in n for n in kernels) != count:
            failures.append(f"{stem}: not {count} instances in "
                            f"{sorted(kernels)}")
    emit("build", seconds=secs, sources=sorted(built), kernels=kernels)
    if failures:
        raise RuntimeError("build checks failed: " + "; ".join(failures))


def phase_kernels(torch, mt):
    """K1 against its plain version at every listed shape; time the
    main-path shape."""
    from mxnet_tpu_torch.ops import attention as att
    dev = torch.device("cuda", 0)
    rng = np.random.default_rng(SEED)
    cases = [
        # name, B, H, Hk, Sq, Sk, D, causal, dtype, lse
        ("main_bf16", 8, 12, 12, 1024, 1024, 64, True, "bfloat16", False),
        ("main_fp32", 8, 12, 12, 1024, 1024, 64, True, "float32", False),
        ("gqa_8to2_s300", 2, 8, 2, 300, 300, 64, True, "bfloat16", False),
        ("causal_sq100_sk300", 2, 4, 4, 100, 300, 64, True, "float32",
         False),
        ("noncausal_d128", 2, 4, 4, 200, 200, 128, False, "bfloat16",
         False),
        ("lse_gqa_d32", 2, 4, 1, 130, 130, 32, True, "float32", True),
        # the bf16 (tensor-core) design at its edges: D 32 and 128, lse,
        # Sq != Sk both ways, one row, lengths off the 16-row fragments
        ("lse_mqa_d32_bf16", 2, 4, 1, 130, 130, 32, True, "bfloat16", True),
        ("causal_sq100_sk300_bf16", 2, 4, 4, 100, 300, 64, True, "bfloat16",
         True),
        ("causal_sq300_sk100_bf16", 2, 4, 4, 300, 100, 64, True, "bfloat16",
         True),
        ("sq1_sk1_bf16", 2, 4, 2, 1, 1, 64, True, "bfloat16", True),
        ("ragged_sq77_sk130_bf16", 2, 4, 2, 77, 130, 64, False, "bfloat16",
         True),
        ("causal_sq130_sk77_d128_bf16", 2, 4, 2, 130, 77, 128, True,
         "bfloat16", True),
        # ViT-S/16's training shape: 196 tokens (not a multiple of the
        # 64-row tiles), non-causal, with lse
        ("vit_bf16", VIT_BATCH, 6, 6, 196, 196, 64, False, "bfloat16",
         True),
        # ViT-S/16's fp32 predict in the zoo phase (batch 2, no lse): the
        # CUDA-core kernel, the last 64-row tile ragged
        ("vit_fp32", 2, 6, 6, 196, 196, 64, False, "float32", False),
        # the f32 (CUDA-core) kernel at its edges in both of its designs:
        # with enough heads for 64-row tiles (B H ceil(Sq / 64) of at
        # least the SM count), and at a few heads, where the warps split
        # the keys of 16-row tiles
        ("ragged_sq77_sk130_fp32_q64", 34, 4, 2, 77, 130, 64, False,
         "float32", True),
        ("causal_sq130_sk77_d128_fp32_q64", 24, 4, 2, 130, 77, 128, True,
         "float32", True),
        ("lse_mqa_d32_fp32_q64", 34, 4, 1, 130, 130, 32, True, "float32",
         True),
        ("ragged_sq77_sk130_fp32", 2, 4, 2, 77, 130, 64, False, "float32",
         True),
        ("causal_sq300_sk100_d128_fp32", 2, 4, 2, 300, 100, 128, True,
         "float32", True),
        ("sq1_sk1_fp32", 2, 4, 2, 1, 1, 64, True, "float32", True),
    ]
    results, failures = {}, []
    for name, B, H, Hk, Sq, Sk, D, causal, dt, want_lse in cases:
        tdt = getattr(torch, dt)

        def mk(*shape):
            return torch.from_numpy(
                rng.standard_normal(shape, dtype=np.float32)).to(dev, tdt)
        q, k, v = mk(B, H, Sq, D), mk(B, Hk, Sk, D), mk(B, Hk, Sk, D)
        got = att.flash_fwd_cuda(q, k, v, causal, None, return_lse=want_lse)
        ref = att._attn_reference(q, k, v, causal, None,
                                  return_lse=want_lse)
        again = att.flash_fwd_cuda(q, k, v, causal, None,
                                   return_lse=want_lse)
        torch.cuda.synchronize()
        if not want_lse:
            got, ref, again = (got,), (ref,), (again,)
        deterministic = all(torch.equal(a, b) for a, b in zip(got, again))
        if not deterministic:
            failures.append(f"{name}: two launches differ")
        errs = []
        for g, r, tol in zip(got, ref, (TOL[dt], LSE_TOL)):
            g, r = g.float(), r.float()
            err = (g - r).abs().max().item()
            if not torch.isfinite(g).all() or not torch.allclose(g, r, **tol):
                failures.append(f"{name}: max |kernel - plain| {err} "
                                f"beyond {tol} (or non-finite)")
            errs.append(err)
        row = dict(shape=[B, H, Hk, Sq, Sk, D], causal=causal, dtype=dt,
                   max_abs_err=errs[0], tol=TOL[dt],
                   bit_identical_relaunch=deterministic)
        if dt == "float32":  # 64, or 16 where the warps split the keys
            row["q_tile"] = att.flash_fwd_f32_tile(B, H, Sq)
            if name.endswith("_q64") and row["q_tile"] != 64:
                failures.append(f"{name}: q tile {row['q_tile']}, not the "
                                "64 rows the case is for")
        if want_lse:
            row.update(lse_max_abs_err=errs[1], lse_tol=LSE_TOL)
        if name in TIMED_CASES:
            bound, by, flops, nbytes = attention_bound_ms(
                B, H, Hk, Sq, Sk, D, causal, dt, lse=want_lse)
            timed(row, "kernel_ms",
                  lambda: att.flash_fwd_cuda(q, k, v, causal, None,
                                             return_lse=want_lse))
            timed(row, "plain_ms",
                  lambda: att._attn_reference(q, k, v, causal, None),
                  iters=5)
            def sdpa():
                return torch.nn.functional.scaled_dot_product_attention(
                    q, k, v, is_causal=causal)

            def kern():
                return att.flash_fwd_cuda(q, k, v, causal, None,
                                          return_lse=want_lse)
            timed(row, "library_ms", sdpa)
            row.update(bound_ms=bound, bound_by=by, flops=flops,
                       bytes=nbytes)
            if dt == "float32":
                # the card's own time of each (kernel_ms and library_ms,
                # by CUDA events around back-to-back calls, read the
                # host where it is the slower side), and the host's
                row["kernel_device_ms"], _ = device_ms(torch, kern)
                row["library_device_ms"], row["library_kernels"] = \
                    device_ms(torch, sdpa)
                row["kernel_host_ms"] = host_ms(torch, kern)
                row["library_host_ms"] = host_ms(torch, sdpa)
        results[name] = row
        emit("kernel_check", name=name, **row)
    if failures:
        raise RuntimeError("kernel checks failed: " + "; ".join(failures))
    return results


def phase_bwd_kernels(torch, mt):
    """K2 and K3 against their plain version at the listed shapes (K1
    with lse gives out and lse); time the main-path shape: each kernel
    alone, the plain backward, and SDPA's backward (torch.autograd.grad
    of its output, the yardstick; the port never calls it)."""
    from mxnet_tpu_torch.ops import attention as att
    dev = torch.device("cuda", 0)
    rng = np.random.default_rng(SEED + 10)
    cases = [
        # name, B, H, Hk, Sq, Sk, D, causal, dtype
        ("main_bf16", 8, 12, 12, 1024, 1024, 64, True, "bfloat16"),
        ("main_fp32", 8, 12, 12, 1024, 1024, 64, True, "float32"),
        ("gqa_8to2_s300", 2, 8, 2, 300, 300, 64, True, "bfloat16"),
        ("causal_sq100_sk300", 2, 4, 4, 100, 300, 64, True, "float32"),
        ("causal_sq300_sk100", 2, 4, 4, 300, 100, 64, True, "float32"),
        ("noncausal_d128", 2, 4, 4, 200, 200, 128, False, "bfloat16"),
        ("mqa_d32", 2, 4, 1, 130, 130, 32, True, "float32"),
        # the bf16 (tensor-core) K2 and K3 designs at their edges; Sq 80
        # ends a q tile after one warp's 16 rows
        ("mqa_d32_bf16", 2, 4, 1, 130, 130, 32, True, "bfloat16"),
        ("causal_sq100_sk300_bf16", 2, 4, 4, 100, 300, 64, True, "bfloat16"),
        ("causal_sq300_sk100_bf16", 2, 4, 4, 300, 100, 64, True, "bfloat16"),
        ("sq1_sk1_bf16", 2, 4, 2, 1, 1, 64, True, "bfloat16"),
        ("ragged_sq77_sk130_bf16", 2, 4, 2, 77, 130, 64, False, "bfloat16"),
        ("causal_sq130_sk77_d128_bf16", 2, 4, 2, 130, 77, 128, True,
         "bfloat16"),
        ("causal_sq80_sk80_bf16", 2, 4, 2, 80, 80, 64, True, "bfloat16"),
        ("vit_bf16", VIT_BATCH, 6, 6, 196, 196, 64, False, "bfloat16"),
        # the f32 (CUDA-core) K2 and K3 at the same edges, and across
        # their 64-row tiles: Sq 80 and 33 end a q tile after 16 and 33
        # rows, Sk 144 and 97 a k tile after 16 and 33
        ("gqa_8to2_s300_fp32", 2, 8, 2, 300, 300, 64, True, "float32"),
        ("sq1_sk1_fp32", 2, 4, 2, 1, 1, 64, True, "float32"),
        ("ragged_sq77_sk130_fp32", 2, 4, 2, 77, 130, 64, False, "float32"),
        ("causal_sq130_sk77_d128_fp32", 2, 4, 2, 130, 77, 128, True,
         "float32"),
        ("causal_sq80_sk80_fp32", 2, 4, 2, 80, 80, 64, True, "float32"),
        ("sq80_sk144_d128_fp32", 1, 4, 1, 80, 144, 128, False, "float32"),
        ("causal_sq33_sk97_d32_fp32", 2, 4, 2, 33, 97, 32, True, "float32"),
        # ViT-S/16's fp32 training shape: 196 tokens, the last tile ragged
        ("vit_fp32", VIT_BATCH, 6, 6, 196, 196, 64, False, "float32"),
    ]
    results, failures = {}, []
    for name, B, H, Hk, Sq, Sk, D, causal, dt in cases:
        tdt = getattr(torch, dt)

        def mk(*shape):
            return torch.from_numpy(
                rng.standard_normal(shape, dtype=np.float32)).to(dev, tdt)
        q, k, v = mk(B, H, Sq, D), mk(B, Hk, Sk, D), mk(B, Hk, Sk, D)
        g = mk(B, H, Sq, D)
        out, lse = att.flash_fwd_cuda(q, k, v, causal, None,
                                      return_lse=True)
        got = att.flash_bwd_cuda(q, k, v, out, lse, g, causal)
        ref = att._flash_bwd_reference(q, k, v, out, lse, g, causal, None)
        again = att.flash_bwd_cuda(q, k, v, out, lse, g, causal)
        torch.cuda.synchronize()
        deterministic = all(torch.equal(a, b) for a, b in zip(got, again))
        if not deterministic:
            failures.append(f"{name}: two launches differ")
        del again
        row = dict(shape=[B, H, Hk, Sq, Sk, D], causal=causal, dtype=dt,
                   tol=BWD_TOL[dt], bit_identical_relaunch=deterministic)
        for gname, a, b in zip(("dq", "dk", "dv"), got, ref):
            a, b = a.float(), b.float()
            err = (a - b).abs().max().item()
            row[f"{gname}_max_abs_err"] = err
            # the size of what is compared: an error of 0 (the kernels
            # and cuBLAS's f32 products may sum in the same order) is
            # not a comparison of zeros
            row[f"{gname}_max_abs"] = b.abs().max().item()
            if a.shape != b.shape or not torch.isfinite(a).all() \
                    or not torch.allclose(a, b, **BWD_TOL[dt]):
                failures.append(f"{name} {gname}: max |kernel - plain| "
                                f"{err} beyond {BWD_TOL[dt]} (or shape / "
                                "non-finite)")
        del got, ref
        if name in TIMED_CASES:
            scale = 1.0 / D ** 0.5
            delta = (g.float() * out.float()).sum(-1)
            qr, kr, vr = (t.detach().clone().requires_grad_()
                          for t in (q, k, v))
            sdpa = torch.nn.functional.scaled_dot_product_attention(
                qr, kr, vr, is_causal=causal)
            timed(row, "dq_kernel_ms", lambda: att.flash_bwd_dq_cuda(
                q, k, v, g, lse, delta, causal, scale))
            timed(row, "dkv_kernel_ms", lambda: att.flash_bwd_dkv_cuda(
                q, k, v, g, lse, delta, causal, scale))
            timed(row, "plain_ms", lambda: att._flash_bwd_reference(
                q, k, v, out, lse, g, causal, None), iters=3)
            timed(row, "library_ms", lambda: torch.autograd.grad(
                sdpa, (qr, kr, vr), g, retain_graph=True))
            del sdpa, qr, kr, vr
            for kind in ("dq", "dkv"):
                bound, by, flops, nbytes = attention_bound_ms(
                    B, H, Hk, Sq, Sk, D, causal, dt, kind)
                row.update({f"{kind}_bound_ms": bound, f"{kind}_bound_by": by,
                            f"{kind}_flops": flops, f"{kind}_bytes": nbytes})
        results[name] = row
        emit("kernel_check_bwd", name=name, **row)
    torch.cuda.empty_cache()
    if failures:
        raise RuntimeError("backward kernel checks failed: "
                           + "; ".join(failures))
    return results


def gpt2_params(sym, seed):
    """Seeded random GPT-2-style weights (N(0, 0.02) matrices and
    biases, LayerNorm gamma near 1, beta near 0), as numpy."""
    S = GPT2_SMALL["seq_len"]
    shapes, _, _ = sym.infer_shape(data=(1, S), softmax_label=(1, S))
    rng = np.random.default_rng(seed)
    params = {}
    for name, shape in zip(sym.list_arguments(), shapes):
        if name in ("data", "softmax_label"):
            continue
        x = rng.standard_normal(shape, dtype=np.float32) * np.float32(0.02)
        if name.endswith("_gamma"):
            x += np.float32(1.0)
        params[name] = x
    return params


def log_probs(p):
    return np.log(np.maximum(p, np.float32(1e-38)))


def phase_serve(torch, mt, sym, params_np):
    from mxnet_tpu_torch.ops import attention as att
    from mxnet_tpu_torch.serving import BucketedPredictor, DynamicBatcher
    S, V = GPT2_SMALL["seq_len"], GPT2_SMALL["vocab_size"]
    ctx = mt.gpu(0)
    t0 = time.monotonic()
    args, aux = mt.params_from_numpy(
        params_np, {}, ctx, sym,
        {"data": (1, S), "softmax_label": (1, S)})
    pred = BucketedPredictor(sym, {"data": (S,), "softmax_label": (S,)},
                             args, aux, buckets=BUCKETS,
                             compute_dtype="bfloat16",
                             data_dtypes={"data": np.int32}, ctx=ctx)
    pred.warmup()
    torch.cuda.synchronize()
    setup_s = time.monotonic() - t0

    rng = np.random.default_rng(SEED + 1)
    reqs = [{"data": rng.integers(0, V, (n, S), dtype=np.int32),
             "softmax_label": np.zeros((n, S), np.float32)}
            for n in REQUEST_ROWS]
    replies = [None] * len(reqs)
    lat = [None] * len(reqs)
    batcher = DynamicBatcher(pred)
    try:
        barrier = threading.Barrier(len(reqs))

        def client(i):
            barrier.wait()
            t = time.monotonic()
            slot = batcher.submit(reqs[i])
            if not slot.done.wait(600):
                raise RuntimeError(f"request {i} timed out")
            lat[i] = time.monotonic() - t
            replies[i] = slot.reply

        threads = [threading.Thread(target=client, args=(i,))
                   for i in range(len(reqs))]
        # the serving path: counts start at 0 here and are read right
        # after
        reset_counts(mt)
        t_start = time.monotonic()
        for th in threads:
            th.start()
        for th in threads:
            th.join(900)
        wall = time.monotonic() - t_start
        counts = read_counts(mt)
        launches = counts["flash_fwd"]
        dispatches = mt.profiler.dispatch_counts().get("serving.predict", 0)
        batches = batcher.batches
    finally:
        batcher.stop()
    if any(r is None for r in replies):
        raise RuntimeError("a request got no reply")
    layers = GPT2_SMALL["num_layers"]
    if launches != layers * dispatches or dispatches == 0 \
            or counts["flash_fwd_lse"] or counts["flash_bwd_dq"] \
            or counts["flash_bwd_dkv"]:
        raise RuntimeError(f"serving launches {counts} != {layers} x "
                           f"{dispatches} predict dispatches of the "
                           "lse-free forward and nothing else")
    worst, bit_equal = 0.0, 0
    for i, (req, reply) in enumerate(zip(reqs, replies)):
        status, payload = reply
        if status != "ok" or payload[0] != "result":
            raise RuntimeError(f"request {i} failed: {reply}")
        got = payload[2][0]
        n = REQUEST_ROWS[i]
        if got.shape != (n * S, V) or not np.isfinite(got).all():
            raise RuntimeError(f"request {i}: reply shape {got.shape} or "
                               "non-finite values")
        _, direct = pred.predict(req)
        diff = float(np.abs(log_probs(got) - log_probs(direct[0])).max())
        bit_equal += int(np.array_equal(got, direct[0]))
        if diff > REPLY_LOGP_TOL:
            raise RuntimeError(f"request {i}: reply differs from a direct "
                               f"predict by {diff} in log-prob")
        worst = max(worst, diff)
    tokens = sum(REQUEST_ROWS) * S
    emit("serve", model="gpt2-small-width", compute_dtype="bfloat16",
         buckets=list(BUCKETS), request_rows=list(REQUEST_ROWS),
         setup_s=setup_s, wall_s=wall, tokens=tokens,
         tokens_per_s=tokens / wall, latency_ms=[x * 1e3 for x in lat],
         batches=batches, predict_dispatches=dispatches,
         launches=counts,
         reply_vs_direct_max_logp_diff=worst,
         reply_vs_direct_tol=REPLY_LOGP_TOL,
         replies_bit_equal=bit_equal)
    return counts, pred


def reset_counts(mt):
    """Every kernel's launch count and the dispatch counters to 0."""
    from mxnet_tpu_torch.ops import attention as att, detection
    att.flash_fwd_cuda.launches = 0
    att.flash_fwd_cuda.lse_launches = 0
    att.flash_bwd_cuda.dq_launches = 0
    att.flash_bwd_cuda.dkv_launches = 0
    detection.suppress_matrix_cuda.launches = 0
    mt.profiler.reset_dispatch_counts()


def read_counts(mt):
    from mxnet_tpu_torch.ops import attention as att, detection
    return {"flash_fwd": att.flash_fwd_cuda.launches,
            "flash_fwd_lse": att.flash_fwd_cuda.lse_launches,
            "flash_bwd_dq": att.flash_bwd_cuda.dq_launches,
            "flash_bwd_dkv": att.flash_bwd_cuda.dkv_launches,
            "nms_suppress": detection.suppress_matrix_cuda.launches}


def device_kernels(prof):
    """[(ms, count, name)] of the kernels the card ran, by name, largest
    first (torch.profiler's key_averages)."""
    kernels = []
    for e in prof.key_averages():
        if "cuda" not in str(getattr(e, "device_type", "")).lower():
            continue
        ms = (getattr(e, "self_device_time_total", None)
              or getattr(e, "self_cuda_time_total", 0)) / 1e3
        if ms > 0:
            kernels.append((ms, e.count, e.key[:90]))
    kernels.sort(reverse=True)
    return kernels


def phase_profile(torch, pred):
    """Where one full bucket's predict goes: the device forward (host
    clock around forward + synchronize), the readback to the host, and
    the kernels the card ran in the forward (torch.profiler), by name."""
    S, V = GPT2_SMALL["seq_len"], GPT2_SMALL["vocab_size"]
    n = BUCKETS[-1]
    rng = np.random.default_rng(SEED + 3)
    datas = {"data": rng.integers(0, V, (n, S), dtype=np.int32),
             "softmax_label": np.zeros((n, S), np.float32)}
    torch.cuda.synchronize()
    t0 = time.monotonic()
    pred.predict(datas)
    predict_s = time.monotonic() - t0
    t0 = time.monotonic()
    _, outs = pred.forward_chunk(datas, n)
    torch.cuda.synchronize()
    forward_s = time.monotonic() - t0
    t0 = time.monotonic()
    host = outs[0].cpu().numpy()
    readback_s = time.monotonic() - t0
    del outs, host
    with device_window(torch) as prof:
        _, outs = pred.forward_chunk(datas, n)
        torch.cuda.synchronize()
    del outs
    kernels = device_kernels(prof)
    busy = sum(k[0] for k in kernels)
    flash = sum(k[0] for k in kernels if "flash_fwd" in k[2])
    if flash <= 0:
        raise RuntimeError("profile: the forward launched K1 12 times but "
                           f"the profile shows no time for it: {kernels}")
    emit("profile", rows=n, tokens=n * S, predict_ms=predict_s * 1e3,
         forward_ms=forward_s * 1e3, readback_ms=readback_s * 1e3,
         readback_bytes=n * S * V * 4, device_busy_ms=busy,
         device_idle_share_of_forward=max(0.0, 1 - busy / (forward_s * 1e3)),
         flash_fwd_ms=flash,
         top_kernels=[dict(ms=ms, count=c, name=k)
                      for ms, c, k in kernels[:10]])


def phase_fp32(torch, mt, sym, params_np):
    """One full-width request in fp32: card (kernel) against CPU (plain
    path), compared in log-probability."""
    from mxnet_tpu_torch.serving import BucketedPredictor
    S, V = GPT2_SMALL["seq_len"], GPT2_SMALL["vocab_size"]
    rng = np.random.default_rng(SEED + 2)
    req = {"data": rng.integers(0, V, (1, S), dtype=np.int32),
           "softmax_label": np.zeros((1, S), np.float32)}
    outs = {}
    for name, ctx in (("gpu", mt.gpu(0)), ("cpu", mt.cpu())):
        args, aux = mt.params_from_numpy(
            params_np, {}, ctx, sym,
            {"data": (1, S), "softmax_label": (1, S)})
        pred = BucketedPredictor(sym, {"data": (S,), "softmax_label": (S,)},
                                 args, aux, buckets=[1],
                                 data_dtypes={"data": np.int32}, ctx=ctx)
        t0 = time.monotonic()
        _, o = pred.predict(req)
        outs[name] = (o[0], time.monotonic() - t0)
        del pred, args, aux
    diff = float(np.abs(log_probs(outs["gpu"][0])
                        - log_probs(outs["cpu"][0])).max())
    if not np.isfinite(outs["gpu"][0]).all() or diff > FP32_LOGP_TOL:
        raise RuntimeError(f"fp32 card vs CPU: max log-prob diff {diff} "
                           f"beyond {FP32_LOGP_TOL}")
    emit("fp32_card_vs_cpu", max_logp_diff=diff, tol=FP32_LOGP_TOL,
         gpu_s=outs["gpu"][1], cpu_s=outs["cpu"][1])


def lm_batch(rng, B, S, V):
    """(data, label) int32 (B, S): a random first token per row, then
    next = (3 * tok + 1) % V — a rule a model can learn."""
    toks = np.empty((B, S + 1), np.int64)
    toks[:, 0] = rng.integers(0, V, B)
    for t in range(S):
        toks[:, t + 1] = (3 * toks[:, t] + 1) % V
    return toks[:, :-1].astype(np.int32), toks[:, 1:].astype(np.int32)


def train_step(mod, batch):
    mod.forward(batch, is_train=True)
    mod.backward()
    mod.update()


def phase_train(torch, mt, sym):
    """GPT-2-small width, all layers, through mt.mod.Module +
    mt.io.NDArrayIter on cuda:0 in bf16 with fp32 masters: TRAIN_STEPS
    steps on one seeded batch, launch counts reset just before and read
    just after, the loss of every step from the CrossEntropy metric (one
    readback per step), then one more step under torch.profiler."""
    S, V, L = (GPT2_SMALL[k] for k in ("seq_len", "vocab_size",
                                       "num_layers"))
    B, D = TRAIN_BATCH, GPT2_SMALL["d_model"]
    x, y = lm_batch(np.random.default_rng(SEED + 4), B, S, V)
    t0 = time.monotonic()
    it = mt.io.NDArrayIter({"data": x}, {"softmax_label": y}, batch_size=B)
    mod = mt.mod.Module(sym, context=mt.gpu(0), compute_dtype="bfloat16")
    mod.bind(data_shapes=it.provide_data, label_shapes=it.provide_label)
    mt.random.seed(SEED)
    mod.init_params(mt.initializer.Xavier(rnd_type="gaussian",
                                          magnitude=2.0))
    mod.init_optimizer(optimizer="adam",
                       optimizer_params={"learning_rate": TRAIN_LR})
    batch = next(it)
    args, _ = mod.get_params()
    n_params = sum(int(np.prod(a.shape)) for a in args.values())
    metric = mt.metric.CrossEntropy()
    torch.cuda.synchronize()
    setup_s = time.monotonic() - t0

    # the training path: counts start at 0 here and are read right after
    torch.cuda.reset_peak_memory_stats()
    reset_counts(mt)
    losses, step_ms = [], []
    for _ in range(TRAIN_STEPS):
        t = time.monotonic()
        train_step(mod, batch)
        metric.reset()
        mod.update_metric(metric, batch.label)
        losses.append(metric.get()[1])
        torch.cuda.synchronize()
        step_ms.append((time.monotonic() - t) * 1e3)
    counts = read_counts(mt)
    dispatch = mt.profiler.dispatch_counts()
    peak = torch.cuda.max_memory_allocated()
    n = TRAIN_STEPS
    want = {"flash_fwd": L * n, "flash_fwd_lse": L * n,
            "flash_bwd_dq": L * n, "flash_bwd_dkv": L * n,
            "nms_suppress": 0}
    if counts != want or dispatch.get("module.update") != n \
            or dispatch.get("module.backward") != n:
        raise RuntimeError(f"train: launches {counts} / dispatches "
                           f"{dispatch} over {n} steps, want {want} and "
                           f"{n} updates and backwards")
    if not all(np.isfinite(losses)):
        raise RuntimeError(f"train: non-finite loss in {losses}")
    if not losses[-1] < losses[0] - TRAIN_MARGIN:
        raise RuntimeError(f"train: last loss {losses[-1]} does not beat "
                           f"the first {losses[0]} by {TRAIN_MARGIN}")
    out = mod.get_outputs()[0]
    if out.shape != (B * S, V):
        raise RuntimeError(f"train: output shape {out.shape}")

    torch.cuda.synchronize()
    with device_window(torch) as prof:
        t = time.monotonic()
        train_step(mod, batch)
        torch.cuda.synchronize()
        prof_step_ms = (time.monotonic() - t) * 1e3
    kernels = device_kernels(prof)
    busy = sum(k[0] for k in kernels)

    # kernel names hold these stems in either design (flash_fwd_kernel,
    # flash_fwd_mma_kernel, ...)
    attn_ms = {stem: sum(k[0] for k in kernels if stem in k[2])
               for stem in ("flash_fwd", "flash_bwd_dq", "flash_bwd_dkv")}
    if not all(attn_ms.values()):
        raise RuntimeError("train_profile: a step launches every attention "
                           f"kernel but the profile shows {attn_ms}")
    tokens = B * S
    # analytic fwd+bwd FLOPs, the formula of
    # benchmark/transformer_bench.py:136-143 (copied): 6 N per token over
    # the matmul parameters (all but the input embedding, a gather) plus
    # the attention score/value term
    flops = 6.0 * (n_params - V * D) * tokens + 12.0 * L * B * S * S * D
    med = float(np.median(step_ms))
    emit("train", model="gpt2-small-width", layers=L, batch=B, seq=S,
         vocab=V, compute_dtype="bfloat16", masters="float32",
         optimizer=f"adam lr {TRAIN_LR}",
         initializer="xavier gaussian magnitude 2", setup_s=setup_s,
         steps=n, losses=losses, margin=TRAIN_MARGIN, step_ms=step_ms,
         median_step_ms=med, tokens_per_s=tokens / (med / 1e3),
         n_params=n_params, flops_per_step=flops,
         achieved_tflops=flops / (med / 1e3) / 1e12,
         peak_mem_bytes=peak, launches=counts, dispatches=dispatch)
    # the profiler slows the host, so the idle share is given against
    # the profiled step and against the unprofiled median step
    emit("train_profile", step_ms=prof_step_ms, device_busy_ms=busy,
         device_idle_share_of_step=max(0.0, 1 - busy / prof_step_ms),
         device_idle_share_of_median_step=max(0.0, 1 - busy / med),
         flash_fwd_ms=attn_ms["flash_fwd"],
         flash_bwd_dq_ms=attn_ms["flash_bwd_dq"],
         flash_bwd_dkv_ms=attn_ms["flash_bwd_dkv"],
         top_kernels=[dict(ms=ms, count=c, name=k)
                      for ms, c, k in kernels[:12]])
    del mod, out
    torch.cuda.empty_cache()
    return counts


def phase_train_fp32(torch, mt):
    """One fp32 Module step (SGD) at full width, FP32_TRAIN_LAYERS layers,
    batch 1: the card (kernels, TF32 off) against the CPU (plain path),
    from the same numpy weights on the same batch.  The card's step
    launches each of K1 (with lse), K2 and K3 once a layer, in f32;
    returns those counts."""
    cfg = dict(GPT2_SMALL, num_layers=FP32_TRAIN_LAYERS)
    S, V = cfg["seq_len"], cfg["vocab_size"]
    sym = mt.models.transformer_lm(**cfg)
    params = gpt2_params(sym, SEED + 6)
    x, y = lm_batch(np.random.default_rng(SEED + 5), 1, S, V)
    res, counts = {}, None
    for name, ctx in (("gpu", mt.gpu(0)), ("cpu", mt.cpu())):
        mod = mt.mod.Module(sym, context=ctx)
        mod.bind([mt.io.DataDesc("data", (1, S), np.int32)],
                 [mt.io.DataDesc("softmax_label", (1, S), np.int32)])
        mod.init_params(arg_params=params)
        mod.init_optimizer(optimizer="sgd",
                           optimizer_params={"learning_rate": FP32_TRAIN_LR})
        batch = mt.io.DataBatch([mt.nd.array(x, ctx=mt.cpu())],
                                [mt.nd.array(y, ctx=mt.cpu())])
        t0 = time.monotonic()
        if name == "gpu":
            # the card's step: counts start at 0 here, read right after
            reset_counts(mt)
            train_step(mod, batch)
            torch.cuda.synchronize()
            counts = read_counts(mt)
        else:
            train_step(mod, batch)
        metric = mt.metric.CrossEntropy()
        mod.update_metric(metric, batch.label)
        loss = metric.get()[1]
        secs = time.monotonic() - t0
        new = {n: a.asnumpy() for n, a in mod.get_params()[0].items()}
        res[name] = (loss, new, secs)
        del mod
    (gl, gnew, gs), (cl, cnew, cs) = res["gpu"], res["cpu"]
    L = FP32_TRAIN_LAYERS
    want = {"flash_fwd": L, "flash_fwd_lse": L, "flash_bwd_dq": L,
            "flash_bwd_dkv": L, "nms_suppress": 0}
    if counts != want:
        raise RuntimeError(f"train fp32: launches {counts}, want {want}")
    worst, worst_name = 0.0, None
    for n, w in params.items():
        dg, dc = gnew[n] - w, cnew[n] - w
        rel = float(np.abs(dg - dc).max() / max(np.abs(dc).max(), 1e-30))
        if not np.isfinite(gnew[n]).all() or rel > FP32_UPDATE_RTOL:
            raise RuntimeError(f"train fp32: {n} update differs by {rel} "
                               f"of its largest element (> "
                               f"{FP32_UPDATE_RTOL})")
        if rel >= worst:
            worst, worst_name = rel, n
    if not np.isfinite(gl) or abs(gl - cl) > FP32_LOSS_TOL:
        raise RuntimeError(f"train fp32: loss {gl} on the card, {cl} on "
                           f"the CPU (tol {FP32_LOSS_TOL})")
    emit("train_fp32_card_vs_cpu", layers=FP32_TRAIN_LAYERS, batch=1,
         loss_gpu=gl, loss_cpu=cl, loss_tol=FP32_LOSS_TOL,
         worst_update_rel_diff=worst, worst_param=worst_name,
         update_rtol=FP32_UPDATE_RTOL, gpu_s=gs, cpu_s=cs, launches=counts)
    torch.cuda.empty_cache()
    return counts


def resnet_batches(torch, mt, device, batch, image_shape, seed):
    """The two synthetic batches of bench.py:379-389, made on ``device``:
    uniform(-1, 1) images and float32 labels in [0, 1000)."""
    gen = torch.Generator(device=device).manual_seed(seed)
    out = []
    for _ in range(2):
        x = torch.rand((batch,) + tuple(image_shape), generator=gen,
                       device=device) * 2 - 1
        y = torch.randint(0, 1000, (batch,), generator=gen,
                          device=device).float()
        out.append(mt.io.DataBatch([mt.nd.NDArray(x)], [mt.nd.NDArray(y)]))
    return out


def resnet_module(mt, ctx, batch, image_shape, compute_dtype, seed):
    """ResNet-50 through Module as bench.py:353-371 builds it."""
    sym = mt.models.get_symbol("resnet",
                               **dict(RESNET, image_shape=image_shape))
    mod = mt.mod.Module(sym, context=ctx, compute_dtype=compute_dtype)
    mod.bind(data_shapes=[("data", (batch,) + tuple(image_shape))],
             label_shapes=[("softmax_label", (batch,))])
    mt.random.seed(seed)
    mod.init_params(mt.initializer.Xavier(rnd_type="gaussian",
                                          magnitude=2.0))
    mod.init_optimizer(optimizer="sgd", optimizer_params=RESNET_OPT)
    return mod


def resnet_steps(mt, mod, batches, n, sync):
    """``n`` steps of ``forward(is_train=True)`` + ``update()`` over the
    batches in turn (bench.py:461-464), each ended by ``sync``: the ms of
    each step on the host clock, and the loss of each (the mean
    cross-entropy of the softmax output, read after the step's time)."""
    metric = mt.metric.CrossEntropy()
    step_ms, losses = [], []
    for i in range(n):
        b = batches[i % len(batches)]
        t = time.monotonic()
        mod.forward(b, is_train=True)
        mod.update()
        sync()
        step_ms.append((time.monotonic() - t) * 1e3)
        metric.reset()
        mod.update_metric(metric, b.label)
        losses.append(metric.get()[1])
    return step_ms, losses


# R1: jax.nn.relu's gradient in one pass (csrc/relu_grad.cu), the
# backward of every relu of the ResNet and zoo paths
R1_SOURCE = os.path.join("mxnet_tpu_torch", "csrc", "relu_grad.cu")
R1_DESIGN = (
    "a grid-stride loop over 16-byte vectors of g, y and the output (8 "
    "bf16 values), the test y > 0 on the bits (b - 1 < the bits of +inf, "
    "unsigned), a scalar tail and a scalar path for misaligned tensors; "
    "at most 8 blocks of 256 an SM; bit-identical to the plain version")
# ResNet-50 v2's largest relu (stage 1's 256-channel activations at batch
# 256) in bf16, and stage 0's 64-channel one in fp32
R1_CASES = {"resnet50_stage1_bf16": ((256, 256, 56, 56), "bfloat16"),
            "resnet50_stem_fp32": ((256, 64, 112, 112), "float32")}


def r1_count():
    from mxnet_tpu_torch.ops import elemwise
    return elemwise.relu_grad_cuda.launches


def reset_r1():
    from mxnet_tpu_torch.ops import elemwise
    elemwise.relu_grad_cuda.launches = 0


def relu_nodes(sym):
    """The relus of a symbol's graph (Activation with act_type relu, or
    the relu op): R1 launches once each a training step."""
    nodes = json.loads(sym.tojson())["nodes"]
    return sum(n["op"] == "relu" or (n["op"] == "Activation" and n.get(
        "attrs", {}).get("act_type", "relu") == "relu") for n in nodes)


def phase_r1_kernel(torch, mt):
    """R1 against its plain version bit for bit at ResNet-50's relu shapes
    (NaN, +-0 and +-inf placed in the output and the cotangent), and on
    a view off its 16-byte alignment (the scalar path); each relaunched
    and required identical; times by CUDA events and the device time
    (torch.profiler) beside the bytes bound, the plain version's two
    passes and torch's own one-pass relu backward (``threshold_backward``:
    g at NaN, so not the same function; context, not a library call)."""
    from mxnet_tpu_torch.ops import elemwise
    dev = torch.device("cuda", 0)
    gen = torch.Generator(device=dev).manual_seed(SEED + 110)
    rows, fails = {}, []
    special = torch.tensor([float("nan"), float("inf"), 0.0, -0.0],
                           device=dev)
    for name, (shape, dtype) in R1_CASES.items():
        dt = getattr(torch, dtype)
        x = torch.randn(shape, generator=gen, device=dev, dtype=dt)
        g = torch.randn(shape, generator=gen, device=dev, dtype=dt)
        x.view(-1)[:4] = special.to(dt)
        g.view(-1)[4:8] = special.to(dt)
        y = torch.relu(x)
        got = elemwise.relu_grad_cuda(g, y)
        again = elemwise.relu_grad_cuda(g, y)
        want = elemwise.relu_grad_plain(g, y)
        off = elemwise.relu_grad_cuda(g.view(-1)[1:], y.view(-1)[1:])
        torch.cuda.synchronize()
        same = all(torch.equal(a.view(torch.int16 if a.element_size() == 2
                                      else torch.int32),
                               b.view(torch.int16 if b.element_size() == 2
                                      else torch.int32))
                   for a, b in ((got, want), (again, want),
                                (off, want.view(-1)[1:])))
        err = float((got.float() - want.float()).nan_to_num().abs().max())
        if not same:
            fails.append(f"{name}: R1 differs from the plain version (or "
                         "from its relaunch, or off its alignment)")
        n = g.numel()
        row = dict(shape=list(shape), dtype=dtype, bit_identical=same,
                   max_abs_err=err)
        def call():
            return elemwise.relu_grad_cuda(g, y)
        timed(row, "kernel_ms", call)
        # the kernel alone by events over launches of its C entry (a
        # torch.profiler window lost one R1 launch of twenty in two of
        # the script's card runs: PERF.md §7), checked bit for bit once
        out = torch.empty_like(got)
        alone = c_entry_launch(torch, "relu_grad.cu", "mxtt_relu_grad", (
            g.data_ptr(), y.data_ptr(), out.data_ptr(), g.numel(),
            elemwise._RELU_DTYPES[g.dtype], dev.index), dev)
        alone()
        torch.cuda.synchronize()
        if not torch.equal(out.view(torch.int16 if out.element_size() == 2
                                    else torch.int32),
                           got.view(torch.int16 if got.element_size() == 2
                                    else torch.int32)):
            fails.append(f"{name}: R1 launched alone differs from its "
                         "wrapper")
        row["device_ms"] = time_ms(alone, iters=20, repeats=5)[0]
        row["device_ms_by"] = ("CUDA events over 20 back-to-back launches "
                               "of the kernel alone, median of 5")
        del out
        timed(row, "plain_ms", lambda: elemwise.relu_grad_plain(g, y))
        timed(row, "torch_threshold_backward_ms",
              lambda: torch.ops.aten.threshold_backward(g, y, 0))
        nbytes = 3 * n * g.element_size()
        row.update(bound_bytes=nbytes,
                   bound_ms=nbytes / PEAK_BYTES_PER_S * 1e3,
                   bound_by="bytes", library_ms=None,
                   library="none: no one PyTorch call gives g where y > 0 "
                           "and 0 elsewhere (threshold_backward passes g "
                           "at NaN)")
        check_bound_share(row, "device_ms", fails, f"r1 {name}")
        rows[name] = row
        del x, g, y, got, again, want, off
        torch.cuda.empty_cache()
    emit("r1_kernel", source=R1_SOURCE, design=R1_DESIGN, cases=rows,
         failures=fails)
    if fails:
        raise RuntimeError("r1_kernel: " + "; ".join(fails))
    return rows


def phase_resnet_train(torch, mt, peak_flops):
    """ResNet-50 at ImageNet width through Module on cuda:0, bench.py's
    recipe: RESNET_WARMUP + RESNET_STEPS steps, launch and dispatch
    counts reset just before and read just after; setup, first step,
    steady steps, images/s, TFLOP/s, MFU, peak memory, every loss."""
    dev = torch.device("cuda", 0)
    B, shape = RESNET_BATCH, (3, 224, 224)
    t0 = time.monotonic()
    mod = resnet_module(mt, mt.gpu(0), B, shape, "bfloat16", SEED)
    batches = resnet_batches(torch, mt, dev, B, shape, SEED)
    args, aux = mod.get_params()
    n_params = sum(int(np.prod(a.shape)) for a in args.values())
    torch.cuda.synchronize()
    setup_s = time.monotonic() - t0

    # the ResNet path: counts start at 0 here and are read right after
    torch.cuda.reset_peak_memory_stats()
    reset_counts(mt)
    reset_r1()
    n = RESNET_WARMUP + RESNET_STEPS
    step_ms, losses = resnet_steps(mt, mod, batches, n,
                                   torch.cuda.synchronize)
    counts = read_counts(mt)
    r1 = r1_count()
    if r1 != n * relu_nodes(mod.symbol):
        raise RuntimeError(f"resnet_train: R1 launched {r1} times over {n} "
                           f"steps of {relu_nodes(mod.symbol)} relus")
    dispatch = mt.profiler.dispatch_counts()
    peak = torch.cuda.max_memory_allocated()
    if dispatch.get("module.update") != n \
            or dispatch.get("module.backward") != n or any(counts.values()):
        raise RuntimeError(f"resnet_train: dispatches {dispatch} over {n} "
                           f"steps (want {n} updates and backwards) and "
                           f"attention launches {counts} (want none)")
    if not all(np.isfinite(losses)):
        raise RuntimeError(f"resnet_train: non-finite loss in {losses}")
    first5, last5 = float(np.mean(losses[:5])), float(np.mean(losses[-5:]))
    if not last5 < first5 - RESNET_MARGIN:
        raise RuntimeError(f"resnet_train: mean of the last 5 losses "
                           f"{last5} does not beat the first 5's {first5} "
                           f"by {RESNET_MARGIN}: {losses}")
    out = mod.get_outputs()[0]
    if out.shape != (B, 1000):
        raise RuntimeError(f"resnet_train: output shape {out.shape}")
    timed_ms = step_ms[RESNET_WARMUP:]
    med = float(np.median(timed_ms))
    flops = 2 * RESNET_FWD_MACS * 3 * B
    tflops = flops / (med / 1e3) / 1e12
    emit("resnet_train", model="resnet-50 v2", batch=B, image=list(shape),
         classes=1000, stem="conv7", layout="NCHW",
         compute_dtype="bfloat16", masters="float32",
         optimizer="sgd lr 0.1 momentum 0.9 wd 1e-4",
         initializer="xavier gaussian magnitude 2", n_params=n_params,
         cudnn_benchmark=torch.backends.cudnn.benchmark, setup_s=setup_s,
         first_step_ms=step_ms[0], warmup_ms=step_ms[:RESNET_WARMUP],
         steps=len(timed_ms), step_ms=timed_ms, median_step_ms=med,
         min_step_ms=min(timed_ms), max_step_ms=max(timed_ms),
         images_per_s=B / (med / 1e3), flops_per_step=flops,
         flops_source="analytic, bench.py:495: 2 x 4.1e9 x 3 x batch",
         achieved_tflops=tflops, mfu=tflops * 1e12 / peak_flops,
         mfu_peak_tflops=peak_flops / 1e12, peak_mem_bytes=peak,
         dispatches=dispatch, attention_launches=counts, losses=losses,
         loss_first5_mean=first5, loss_last5_mean=last5,
         margin=RESNET_MARGIN, relu_grad_launches=r1)
    return mod, batches, med, r1


def profiled_step(torch, mod, batch):
    """One more training step (forward and update) under
    torch.profiler: (the step's ms, the card's busy ms, its kernels as
    ``device_kernels`` gives them).  Raises when the card shows no
    time."""
    torch.cuda.synchronize()
    with device_window(torch) as prof:
        t = time.monotonic()
        mod.forward(batch, is_train=True)
        mod.update()
        torch.cuda.synchronize()
        step_ms = (time.monotonic() - t) * 1e3
    kernels = device_kernels(prof)
    busy = sum(k[0] for k in kernels)
    if busy <= 0:
        raise RuntimeError("profile: no device time for a training step")
    return step_ms, busy, kernels


def phase_resnet_profile(torch, mod, batches, median_ms):
    """One more ResNet-50 step under torch.profiler: the card's busy time,
    its idle share of the profiled step and of the median step, and the
    largest kernels."""
    prof_step_ms, busy, kernels = profiled_step(torch, mod, batches[0])
    emit("resnet_profile", step_ms=prof_step_ms, device_busy_ms=busy,
         device_idle_share_of_step=max(0.0, 1 - busy / prof_step_ms),
         device_idle_share_of_median_step=max(0.0, 1 - busy / median_ms),
         kernel_launches=sum(k[1] for k in kernels),
         top_kernels=[dict(ms=ms, count=c, name=k)
                      for ms, c, k in kernels[:12]])


def resnet_numpy_params(mt, batch, image_shape, seed):
    """Seeded He-scaled ResNet-50 weights, gamma near 1, small beta and
    moving statistics near (0, 1), as numpy."""
    sym = mt.models.get_symbol("resnet",
                               **dict(RESNET, image_shape=image_shape))
    arg_shapes, _, aux_shapes = sym.infer_shape(
        data=(batch,) + tuple(image_shape), softmax_label=(batch,))
    rng = np.random.default_rng(seed)
    args, aux = {}, {}
    for name, shape in zip(sym.list_arguments(), arg_shapes):
        if name in ("data", "softmax_label"):
            continue
        x = rng.standard_normal(shape, dtype=np.float32)
        if name.endswith("_weight"):
            x *= np.float32(np.sqrt(2.0 / np.prod(shape[1:])))
        elif name.endswith("_gamma"):
            x = np.float32(1) + np.float32(0.1) * x
        else:
            x *= np.float32(0.1)
        args[name] = x
    for name, shape in zip(sym.list_auxiliary_states(), aux_shapes):
        x = rng.uniform(0.5, 1.5, shape) if name.endswith("_var") \
            else rng.standard_normal(shape) * 0.1
        aux[name] = x.astype(np.float32)
    return sym, args, aux


def resnet_fp32_step(mt, ctx, sym, args, aux, x, y):
    """One fp32 SGD-momentum step on ``ctx``: (loss, new params, new
    moving statistics, seconds)."""
    mod = mt.mod.Module(sym, context=ctx)
    mod.bind(data_shapes=[("data", x.shape)],
             label_shapes=[("softmax_label", y.shape)])
    mod.init_params(arg_params=args, aux_params=aux)
    mod.init_optimizer(optimizer="sgd", optimizer_params=RESNET_OPT)
    batch = mt.io.DataBatch([mt.nd.array(x, ctx=mt.cpu())],
                            [mt.nd.array(y, ctx=mt.cpu())])
    t0 = time.monotonic()
    mod.forward(batch, is_train=True)
    mod.backward()
    mod.update()
    metric = mt.metric.CrossEntropy()
    mod.update_metric(metric, batch.label)
    loss = metric.get()[1]
    secs = time.monotonic() - t0
    new_args, new_aux = mod.get_params()
    return (loss, {n: a.asnumpy() for n, a in new_args.items()},
            {n: a.asnumpy() for n, a in new_aux.items()}, secs)


def phase_resnet_fp32(torch, mt):
    """One fp32 step of ResNet-50 at full depth and width, reduced image
    and batch: the card (TF32 off) against the CPU, from the same numpy
    weights on the same batch."""
    B, shape = RESNET_FP32_BATCH, RESNET_FP32_IMAGE
    sym, args, aux = resnet_numpy_params(mt, B, shape, SEED + 7)
    rng = np.random.default_rng(SEED + 8)
    x = rng.uniform(-1, 1, (B,) + shape).astype(np.float32)
    y = rng.integers(0, 1000, B).astype(np.float32)
    res = {name: resnet_fp32_step(mt, ctx, sym, args, aux, x, y)
           for name, ctx in (("gpu", mt.gpu(0)), ("cpu", mt.cpu()))}
    (gl, gargs, gaux, gs), (cl, cargs, caux, cs) = res["gpu"], res["cpu"]
    if not all(np.isfinite(v).all() for v in (*gargs.values(),
                                               *gaux.values())):
        raise RuntimeError("resnet fp32: non-finite parameters on the card")

    def rel(got, want):
        return float(np.abs(got - want).max()
                     / max(np.abs(want).max(), 1e-30))
    upd = {n: (gargs[n] - args[n], cargs[n] - args[n]) for n in args}
    per_param = {n: rel(g, c) for n, (g, c) in upd.items()}
    aux_rel = {n: rel(gaux[n], caux[n]) for n in caux}
    head = max(per_param[n] for n in ("fc1_weight", "fc1_bias"))
    norm = float(np.sqrt(sum(((g - c) ** 2).sum() for g, c in upd.values()))
                 / np.sqrt(sum((c ** 2).sum() for _, c in upd.values())))
    worst_p = max(per_param, key=per_param.get)
    worst_a = max(aux_rel, key=aux_rel.get)
    fails = []
    if not np.isfinite(gl) or abs(gl - cl) > RESNET_FP32_LOSS_TOL:
        fails.append(f"loss {gl} on the card, {cl} on the CPU")
    if aux_rel[worst_a] > RESNET_FP32_AUX_RTOL:
        fails.append(f"{worst_a} differs by {aux_rel[worst_a]}")
    if head > RESNET_FP32_HEAD_RTOL:
        fails.append(f"fc1's update differs by {head}")
    if norm > RESNET_FP32_UPDATE_NORM_RTOL:
        fails.append(f"the update differs by {norm} of its norm")
    emit("resnet_fp32_card_vs_cpu", model="resnet-50 v2 full depth and "
         "width", cut=f"batch {B}, image {list(shape)} (not 256, 224)",
         loss_gpu=gl, loss_cpu=cl, loss_tol=RESNET_FP32_LOSS_TOL,
         worst_aux_rel_diff=aux_rel[worst_a], worst_aux=worst_a,
         aux_rtol=RESNET_FP32_AUX_RTOL, head_update_rel_diff=head,
         head_rtol=RESNET_FP32_HEAD_RTOL, update_norm_rel_diff=norm,
         update_norm_rtol=RESNET_FP32_UPDATE_NORM_RTOL,
         worst_update_rel_diff=per_param[worst_p], worst_param=worst_p,
         gpu_s=gs, cpu_s=cs, failures=fails)
    if fails:
        raise RuntimeError("resnet fp32: " + "; ".join(fails))
    torch.cuda.empty_cache()


class SyntheticIter:
    """A DataIter of ``batches`` copies of one seeded synthetic batch, as
    examples/image_classification/train_imagenet.py's SyntheticIter."""

    def __init__(self, mt, batch_size, image_shape, batches, seed):
        rng = np.random.RandomState(seed)
        self._x = mt.nd.array(rng.uniform(-1, 1, (batch_size,)
                                          + image_shape).astype("float32"),
                              ctx=mt.cpu())
        self._y = mt.nd.array(rng.randint(0, 1000, (batch_size,))
                              .astype("float32"), ctx=mt.cpu())
        self._mt, self._n, self._i = mt, batches, 0
        self.provide_data = [mt.io.DataDesc("data",
                                            (batch_size,) + image_shape)]
        self.provide_label = [mt.io.DataDesc("softmax_label",
                                             (batch_size,))]

    def __iter__(self):
        return self

    def reset(self):
        self._i = 0

    def __next__(self):
        if self._i >= self._n:
            raise StopIteration
        self._i += 1
        return self._mt.io.DataBatch([self._x], [self._y])


def phase_resnet_fit_checkpoint(torch, mt, workdir):
    """Module.fit for one epoch (examples/common.py:63-100's recipe:
    MultiFactorScheduler, Speedometer, do_checkpoint, eval_metric acc),
    then Module.load of the checkpoint with its optimizer states: every
    arg, aux and momentum, and one inference forward, bit for bit."""
    shape = (3, 224, 224)
    it = SyntheticIter(mt, FIT_BATCH, shape, FIT_BATCHES, SEED + 9)
    prefix = os.path.join(workdir, "resnet50")
    mod = mt.mod.Module(mt.models.get_symbol("resnet", **RESNET),
                        context=mt.gpu(0), compute_dtype="bfloat16")
    mt.random.seed(SEED)
    sched = mt.lr_scheduler.MultiFactorScheduler(step=[2, 3], factor=0.1)
    t0 = time.monotonic()
    mod.fit(it, num_epoch=1, optimizer="sgd",
            optimizer_params=dict(RESNET_OPT, lr_scheduler=sched),
            initializer=mt.initializer.Xavier(rnd_type="gaussian",
                                              factor_type="in",
                                              magnitude=2),
            batch_end_callback=mt.callback.Speedometer(FIT_BATCH, 2),
            epoch_end_callback=[mt.callback.do_checkpoint(prefix),
                                mt.callback.module_checkpoint(
                                    mod, prefix + "-full", 1, True)],
            eval_metric="acc")
    torch.cuda.synchronize()
    fit_s = time.monotonic() - t0
    files = sorted(os.listdir(workdir))
    want = ["resnet50-0001.params", "resnet50-full-0001.params",
            "resnet50-full-0001.states", "resnet50-full-symbol.json",
            "resnet50-symbol.json"]
    if files != want:
        raise RuntimeError(f"fit checkpoint: files {files}, want {want}")
    loaded = mt.mod.Module.load(prefix + "-full", 1,
                                load_optimizer_states=True,
                                context=mt.gpu(0), compute_dtype="bfloat16")
    loaded.bind(data_shapes=it.provide_data,
                label_shapes=it.provide_label)
    loaded.init_optimizer(optimizer="sgd",
                          optimizer_params=dict(RESNET_OPT,
                                                lr_scheduler=sched))
    (a1, x1), (a2, x2) = mod.get_params(), loaded.get_params()
    s1, s2 = mod._updater.states, loaded._updater.states
    mism = [n for n in a1 if not torch.equal(a1[n]._data, a2[n]._data)]
    mism += [n for n in x1 if not torch.equal(x1[n]._data, x2[n]._data)]
    mism += [n for n in s1 if len(s1[n]) != len(s2[n]) or not all(
        torch.equal(p._data, q._data) for p, q in zip(s1[n], s2[n]))]
    if mism or set(a1) != set(a2) or set(s1) != set(s2):
        raise RuntimeError(f"fit checkpoint: reload differs in {mism[:5]}")
    it.reset()
    batch = next(it)
    mod.forward(batch, is_train=False)
    loaded.forward(batch, is_train=False)
    o1, o2 = mod.get_outputs()[0]._data, loaded.get_outputs()[0]._data
    if o1.shape != (FIT_BATCH, 1000) or not torch.isfinite(o1).all() \
            or not torch.equal(o1, o2):
        raise RuntimeError("fit checkpoint: the reloaded module's "
                           "inference output differs from the trained one")
    emit("resnet_fit_checkpoint", batch=FIT_BATCH, batches=FIT_BATCHES,
         image=list(shape), fit_s=fit_s, files=files,
         params=len(a1), aux=len(x1), optimizer_states=len(s1),
         bytes=sum(os.path.getsize(os.path.join(workdir, f))
                   for f in files),
         bit_identical_reload=True, bit_identical_inference=True)


def decode_state_names(layers):
    return [f"layer{i}_{kv}_cache" for i in range(layers)
            for kv in ("k", "v")] + ["cur_pos"]


def decode_module(mt, params_np, batch, ctx):
    """transformer_decode_step at GPT-2 small through Module(state_names)
    with the LM's weights, states zeroed (decode_bench.py:50-66)."""
    cfg = {k: v for k, v in GPT2_SMALL.items()
           if k not in ("vocab_size", "seq_len")}
    dec = mt.models.transformer_decode_step(
        GPT2_SMALL["vocab_size"], GPT2_SMALL["seq_len"], batch, **cfg)
    mod = mt.mod.Module(dec, context=ctx, data_names=("data",),
                        label_names=None,
                        state_names=decode_state_names(cfg["num_layers"]))
    mod.bind(data_shapes=[("data", (batch,))], for_training=False)
    mod.init_params(arg_params=params_np)
    mod.set_states(value=0)
    return mod


def decode_step(mt, mod, tok):
    """One step of decode_bench.py's loop: forward, outputs, the new
    caches and position back in as states."""
    mod.forward(mt.io.DataBatch([tok], []), is_train=False)
    outs = mod.get_outputs()
    mod.set_states(states=outs[1:])
    return outs[0]


def phase_decode(torch, mt, params_np):
    """decode_bench.py on the card: per batch, DECODE_WARMUP steps, then
    DECODE_STEPS timed with one readback at the end; launch counts reset
    just before and read just after; then one step under torch.profiler."""
    L, D, H = (GPT2_SMALL[k] for k in ("num_layers", "d_model",
                                       "num_heads"))
    rows = {}
    for B in DECODE_BATCHES:
        t0 = time.monotonic()
        mod = decode_module(mt, params_np, B, mt.gpu(0))
        tok = mt.nd.zeros((B,), ctx=mt.gpu(0))
        torch.cuda.synchronize()
        setup_s = time.monotonic() - t0
        torch.cuda.reset_peak_memory_stats()
        reset_counts(mt)
        for _ in range(DECODE_WARMUP):
            decode_step(mt, mod, tok)
        torch.cuda.synchronize()
        t0 = time.monotonic()
        for _ in range(DECODE_STEPS):
            out = decode_step(mt, mod, tok)
        logits = out.asnumpy()
        secs = time.monotonic() - t0
        counts = read_counts(mt)
        peak = torch.cuda.max_memory_allocated()
        pos = mod.get_states()[-1].asnumpy()
        want_pos = DECODE_WARMUP + DECODE_STEPS
        if any(counts.values()) or not np.all(pos == want_pos) \
                or logits.shape != (B, GPT2_SMALL["vocab_size"]) \
                or not np.isfinite(logits).all():
            raise RuntimeError(f"decode batch {B}: attention launches "
                               f"{counts} (want none), cur_pos {pos} (want "
                               f"{want_pos}), logits {logits.shape} or "
                               "non-finite")
        step_ms = secs / DECODE_STEPS * 1e3
        torch.cuda.synchronize()
        with device_window(torch) as prof:
            t = time.monotonic()
            decode_step(mt, mod, tok)
            torch.cuda.synchronize()
            prof_ms = (time.monotonic() - t) * 1e3
        kernels = device_kernels(prof)
        busy = sum(k[0] for k in kernels)
        cache_bytes = 2 * L * B * H * GPT2_SMALL["seq_len"] * (D // H) * 4
        rows[B] = dict(batch=B, step_ms=step_ms,
                       tokens_per_s=B * DECODE_STEPS / secs,
                       tokens_per_s_per_stream=DECODE_STEPS / secs,
                       setup_s=setup_s, peak_mem_bytes=peak,
                       cache_bytes=cache_bytes, final_cur_pos=float(pos[0]),
                       launches=counts, profiled_step_ms=prof_ms,
                       device_busy_ms=busy,
                       device_idle_share_of_step=max(0.0, 1 - busy / step_ms),
                       device_idle_share_of_profiled_step=max(
                           0.0, 1 - busy / prof_ms),
                       kernel_launches=sum(k[1] for k in kernels),
                       top_kernels=[dict(ms=ms, count=c, name=k)
                                    for ms, c, k in kernels[:8]])
        emit("decode", model="gpt2-small decode step", dtype="float32",
             tf32=False, max_len=GPT2_SMALL["seq_len"],
             warmup=DECODE_WARMUP, steps=DECODE_STEPS, **rows[B])
        del mod, tok, out
        torch.cuda.empty_cache()
    return rows


def log_softmax_np(x):
    x = x.astype(np.float64)
    m = x.max(-1, keepdims=True)
    return x - m - np.log(np.exp(x - m).sum(-1, keepdims=True))


def lm_logprobs(mt, params_np, toks, ctx):
    """log of the teacher-forced LM's softmax (B, S, V), fp32, through
    Module; the LM's pos_embed_weight stays (1024, d), sliced to S."""
    B, S = toks.shape
    net = mt.models.transformer_lm(**dict(GPT2_SMALL, seq_len=S,
                                          max_len=GPT2_SMALL["seq_len"]))
    mod = mt.mod.Module(net, context=ctx)
    mod.bind([mt.io.DataDesc("data", (B, S), np.int32)],
             [mt.io.DataDesc("softmax_label", (B, S), np.int32)],
             for_training=False)
    mod.init_params(arg_params=params_np)
    mod.forward(mt.io.DataBatch([mt.nd.array(toks, ctx=mt.cpu())],
                                [mt.nd.array(np.zeros_like(toks),
                                             ctx=mt.cpu())]),
                is_train=False)
    probs = mod.get_outputs()[0].asnumpy().reshape(B, S, -1)
    return log_probs(probs)


def phase_decode_vs_lm(torch, mt, params_np):
    """One 1024-token sequence through the LM (seq 1024, K1's fp32 kernel)
    and its first DECODE_STEPS tokens one by one through the decode step,
    fp32 on the card: the log-softmax must agree at every position."""
    S, V, L = (GPT2_SMALL[k] for k in ("seq_len", "vocab_size",
                                       "num_layers"))
    toks = np.random.default_rng(SEED + 11).integers(0, V, (1, S),
                                                     dtype=np.int32)
    reset_counts(mt)
    ref = lm_logprobs(mt, params_np, toks, mt.gpu(0))[0]
    lm_counts = read_counts(mt)
    mod = decode_module(mt, params_np, 1, mt.gpu(0))
    diffs = []
    for t in range(DECODE_STEPS):
        tok = mt.nd.array(toks[:, t].astype(np.float32), ctx=mt.cpu())
        logits = decode_step(mt, mod, tok).asnumpy()[0]
        diffs.append(float(np.abs(log_softmax_np(logits) - ref[t]).max()))
    worst = max(diffs)
    emit("decode_vs_lm", positions=DECODE_STEPS, seq=S, dtype="float32",
         max_abs_logp_diff=worst, tol=DECODE_LOGP_TOL,
         worst_position=int(np.argmax(diffs)), lm_launches=lm_counts,
         logp_range=[float(ref[:DECODE_STEPS].min()),
                     float(ref[:DECODE_STEPS].max())])
    if lm_counts["flash_fwd"] != L or not np.isfinite(worst) \
            or worst > DECODE_LOGP_TOL:
        raise RuntimeError(f"decode_vs_lm: max log-prob diff {worst} "
                           f"(tol {DECODE_LOGP_TOL}), LM launches "
                           f"{lm_counts} (want {L} of K1)")
    del mod
    torch.cuda.empty_cache()


def phase_beam(torch, mt, params_np):
    """beam_search on the card: beam 1 equals the card's greedy argmax
    rollout; beam BEAM_SIZE's scores equal the teacher-forced LM's
    re-scoring of the returned sequences, beams come best-first, and the
    search itself launches no attention kernel."""
    prompts = np.array(BEAM_PROMPTS)
    P, K, G = len(prompts), BEAM_SIZE, BEAM_GEN
    mod = decode_module(mt, params_np, P, mt.gpu(0))
    tok, greedy = prompts.astype(np.float32), [prompts.copy()]
    for _ in range(G):
        logits = decode_step(mt, mod, mt.nd.array(tok, ctx=mt.cpu()))
        tok = logits.asnumpy().argmax(1).astype(np.float32)
        greedy.append(tok.astype(np.int64))
    greedy = np.stack(greedy, 1)
    seqs1, _ = mt.models.beam_search(mod, prompts, beam_size=1, gen_len=G)
    del mod
    mod = decode_module(mt, params_np, P * K, mt.gpu(0))
    torch.cuda.synchronize()
    reset_counts(mt)
    t0 = time.monotonic()
    seqs, scores = mt.models.beam_search(mod, prompts, beam_size=K,
                                         gen_len=G)
    beam_s = time.monotonic() - t0
    counts = read_counts(mt)
    del mod
    flat = seqs.reshape(P * K, G + 1)
    lp = lm_logprobs(mt, params_np, flat.astype(np.int32), mt.gpu(0))
    rescored = np.array([lp[i, np.arange(G), flat[i, 1:]].sum()
                         for i in range(P * K)]).reshape(P, K) / G
    diff = float(np.abs(rescored - scores).max())
    beam1_is_greedy = bool(np.array_equal(seqs1[:, 0, :], greedy))
    fails = []
    if not beam1_is_greedy:
        fails.append("beam 1 differs from the greedy rollout")
    if not np.isfinite(scores).all() or diff > BEAM_SCORE_TOL:
        fails.append(f"scores differ from the re-scoring by {diff}")
    if not np.all(np.diff(scores, axis=1) <= 0):
        fails.append("beams are not sorted best-first")
    if any(counts.values()):
        fails.append(f"the search launched attention kernels {counts}")
    emit("beam", prompts=P, beam=K, batch=P * K, gen_len=G,
         max_len=GPT2_SMALL["seq_len"], dtype="float32", search_s=beam_s,
         tokens_per_s=P * K * G / beam_s, beam1_equals_greedy=beam1_is_greedy,
         max_abs_score_diff=diff, tol=BEAM_SCORE_TOL,
         scores=scores.tolist(), launches=counts, failures=fails)
    if fails:
        raise RuntimeError("beam: " + "; ".join(fails))
    torch.cuda.empty_cache()


def phase_vit_train(torch, mt):
    """ViT-S/16 at ImageNet width through Module on cuda:0, bf16 over
    fp32 masters: VIT_WARMUP + VIT_STEPS steps with the launch counts
    reset just before and read just after (each of K1 with lse, K2 and K3
    exactly VIT_LAYERS times a step), every loss, then one step under
    torch.profiler."""
    dev = mt.gpu(0).torch_device()
    B, shape = VIT_BATCH, (3, 224, 224)
    t0 = time.monotonic()
    mod = mt.mod.Module(mt.models.vit(1000), context=mt.gpu(0),
                        compute_dtype="bfloat16")
    mod.bind(data_shapes=[("data", (B,) + shape)],
             label_shapes=[("softmax_label", (B,))])
    mt.random.seed(SEED)
    mod.init_params(mt.initializer.Xavier(rnd_type="gaussian",
                                          magnitude=2.0))
    mod.init_optimizer(optimizer="adam",
                       optimizer_params={"learning_rate": VIT_LR})
    batches = resnet_batches(torch, mt, dev, B, shape, SEED + 12)
    args, _ = mod.get_params()
    n_params = sum(int(np.prod(a.shape)) for a in args.values())
    torch.cuda.synchronize()
    setup_s = time.monotonic() - t0

    # the ViT path: counts start at 0 here and are read right after
    torch.cuda.reset_peak_memory_stats()
    reset_counts(mt)
    n = VIT_WARMUP + VIT_STEPS
    step_ms, losses = resnet_steps(mt, mod, batches, n,
                                   torch.cuda.synchronize)
    counts = read_counts(mt)
    dispatch = mt.profiler.dispatch_counts()
    peak = torch.cuda.max_memory_allocated()
    want = {k: VIT_LAYERS * n for k in ("flash_fwd", "flash_fwd_lse",
                                         "flash_bwd_dq", "flash_bwd_dkv")}
    want["nms_suppress"] = 0
    first5, last5 = float(np.mean(losses[:5])), float(np.mean(losses[-5:]))
    fails = []
    if counts != want or dispatch.get("module.update") != n:
        fails.append(f"launches {counts} / dispatches {dispatch}, want "
                     f"{want} and {n} updates")
    if not all(np.isfinite(losses)):
        fails.append(f"non-finite loss in {losses}")
    if not last5 < first5 - VIT_MARGIN:
        fails.append(f"mean of the last 5 losses {last5} does not beat the "
                     f"first 5's {first5} by {VIT_MARGIN}")
    if mod.get_outputs()[0].shape != (B, 1000):
        fails.append(f"output shape {mod.get_outputs()[0].shape}")
    timed_ms = step_ms[VIT_WARMUP:]
    med = float(np.median(timed_ms))
    flops = 3 * VIT_FWD_FLOPS * B
    torch.cuda.synchronize()
    with device_window(torch) as prof:
        t = time.monotonic()
        mod.forward(batches[0], is_train=True)
        mod.update()
        torch.cuda.synchronize()
        prof_ms = (time.monotonic() - t) * 1e3
    kernels = device_kernels(prof)
    busy = sum(k[0] for k in kernels)
    attn_ms = {stem: sum(k[0] for k in kernels if stem in k[2])
               for stem in ("flash_fwd", "flash_bwd_dq", "flash_bwd_dkv")}
    if not all(attn_ms.values()):
        fails.append(f"the profile shows no time for an attention kernel: "
                     f"{attn_ms}")
    emit("vit_train", model="vit-s/16 (deit-s widths, gap head)", batch=B,
         image=list(shape), tokens=196, layers=VIT_LAYERS, d_model=384,
         heads=6, classes=1000, compute_dtype="bfloat16",
         masters="float32", optimizer=f"adam lr {VIT_LR}",
         initializer="xavier gaussian magnitude 2", n_params=n_params,
         setup_s=setup_s, first_step_ms=step_ms[0],
         warmup_ms=step_ms[:VIT_WARMUP], steps=len(timed_ms),
         step_ms=timed_ms, median_step_ms=med, min_step_ms=min(timed_ms),
         max_step_ms=max(timed_ms), images_per_s=B / (med / 1e3),
         flops_per_step=flops, flops_source="analytic, VIT_FWD_FLOPS x 3",
         achieved_tflops=flops / (med / 1e3) / 1e12,
         mfu=flops / (med / 1e3) / PEAK_FLOPS["bfloat16"],
         peak_mem_bytes=peak, launches=counts, dispatches=dispatch,
         losses=losses, loss_first5_mean=first5, loss_last5_mean=last5,
         margin=VIT_MARGIN, profiled_step_ms=prof_ms, device_busy_ms=busy,
         device_idle_share_of_median_step=max(0.0, 1 - busy / med),
         device_idle_share_of_profiled_step=max(0.0, 1 - busy / prof_ms),
         flash_fwd_ms=attn_ms["flash_fwd"],
         flash_bwd_dq_ms=attn_ms["flash_bwd_dq"],
         flash_bwd_dkv_ms=attn_ms["flash_bwd_dkv"],
         top_kernels=[dict(ms=ms, count=c, name=k)
                      for ms, c, k in kernels[:12]], failures=fails)
    if fails:
        raise RuntimeError("vit_train: " + "; ".join(fails))
    del mod, batches
    torch.cuda.empty_cache()
    return counts


def zoo_params(net, shape, seed):
    """He-scaled weights, gamma near 1, small biases, moving statistics
    near (0, 1), as numpy."""
    arg_shapes, _, aux_shapes = net.infer_shape(
        data=(2,) + shape, softmax_label=(2,))
    rng = np.random.default_rng(seed)
    args, aux = {}, {}
    for n, s in zip(net.list_arguments(), arg_shapes):
        if n in ("data", "softmax_label"):
            continue
        x = rng.standard_normal(s, dtype=np.float32)
        if n.endswith("_weight") and len(s) > 1:
            x *= np.float32(np.sqrt(2.0 / np.prod(s[1:])))
        elif n.endswith("_gamma"):
            x = np.float32(1) + np.float32(0.1) * x
        else:
            x *= np.float32(0.1)
        args[n] = x
    for n, s in zip(net.list_auxiliary_states(), aux_shapes):
        x = rng.uniform(0.5, 1.5, s) if n.endswith("_var") \
            else rng.standard_normal(s) * 0.1
        aux[n] = x.astype(np.float32)
    return args, aux


def zoo_case(mt, i):
    """ZOO's i-th network at its published input: (name, classes, net,
    args, aux, three images)."""
    name, kwargs, shape = ZOO[i]
    kwargs = dict(kwargs)
    classes = kwargs.pop("num_classes", 1000)
    net = mt.models.get_symbol(name, num_classes=classes, **kwargs)
    args, aux = zoo_params(net, shape, SEED + 20 + i)
    x = np.random.default_rng(SEED + 40 + i).uniform(
        -1, 1, (3,) + shape).astype(np.float32)
    return name, classes, net, args, aux, x


def edit_graph(mt, net, fn):
    """``net`` rebuilt from its JSON after ``fn(graph)`` edits it."""
    graph = json.loads(net.tojson())
    fn(graph)
    return mt.sym.load_json(json.dumps(graph))


def without_dropout(mt, net):
    """``net`` with every Dropout's p set to 0."""
    def edit(graph):
        for node in graph["nodes"]:
            if node["op"] == "Dropout":
                node.setdefault("attrs", {})["p"] = "0.0"
    return edit_graph(mt, net, edit)


def logits_graph(mt, net):
    """``net`` cut at its SoftmaxOutput's input: it outputs the logits
    and takes no label."""
    def edit(graph):
        head = [n for n in graph["nodes"] if n["op"] == "SoftmaxOutput"]
        graph["heads"] = [head[0]["inputs"][0]]
    return edit_graph(mt, net, edit)


def zoo_predict(mt, net, args, aux, x, ctx):
    """``Module.predict`` of ``net`` over ``x`` in batches of 2 (the last
    one padded)."""
    label = "softmax_label" in net.list_arguments()
    it = mt.io.NDArrayIter(
        x, np.zeros(len(x), np.float32) if label else None, batch_size=2)
    mod = mt.mod.Module(net, context=ctx,
                        label_names=("softmax_label",) if label else None)
    mod.bind(data_shapes=it.provide_data, label_shapes=it.provide_label,
             for_training=False)
    mod.init_params(arg_params=args, aux_params=aux)
    return mod.predict(it).asnumpy()


def phase_zoo_predict(torch, mt):
    """Module.predict of every zoo network, fp32, on a padded iterator:
    its logits on the card against the CPU's, relative to their range;
    its probabilities on the card against the softmax of the card's
    logits; the flash forward's launches (12 a batch for ViT, none
    elsewhere); a Dropout network's card predict must equal its predict
    with every Dropout removed (inference is the identity)."""
    rows, fails, vit_counts = {}, [], None
    batches = 2    # 3 images in batches of 2
    for i in range(len(ZOO)):
        name, classes, net, args, aux, x = zoo_case(mt, i)
        reset_counts(mt)
        t0 = time.monotonic()
        probs = zoo_predict(mt, net, args, aux, x, mt.gpu(0))
        gpu_s = time.monotonic() - t0
        counts = read_counts(mt)
        want = {k: 0 for k in counts}
        if name == "vit":
            want["flash_fwd"] = VIT_LAYERS * batches
            vit_counts = counts
        if counts != want:
            fails.append(f"{name}: attention launches {counts}, want {want}")
        lnet = logits_graph(mt, net)
        gpu = zoo_predict(mt, lnet, args, aux, x, mt.gpu(0))
        t0 = time.monotonic()
        cpu = zoo_predict(mt, lnet, args, aux, x, mt.cpu())
        cpu_s = time.monotonic() - t0
        spread = float(cpu.max() - cpu.min())
        rel = float(np.abs(gpu - cpu).max()) / spread
        z = np.exp(gpu - gpu.max(1, keepdims=True))
        soft = float(np.abs(probs - z / z.sum(1, keepdims=True)).max())
        row = dict(shape=list(probs.shape), logit_spread=spread,
                   max_abs_logit_diff_rel=rel, probs_vs_softmax=soft,
                   max_prob=float(probs.max()), launches=counts,
                   gpu_s=gpu_s, cpu_s=cpu_s)
        if probs.shape != (3, classes) or not np.isfinite(probs).all() \
                or not np.isfinite(gpu).all() or rel > ZOO_LOGIT_TOL \
                or soft > ZOO_SOFTMAX_TOL:
            fails.append(f"{name}: shape {probs.shape}, card vs CPU logits "
                         f"{rel} of their spread, probabilities vs the "
                         f"softmax of the logits {soft}")
        if name in ZOO_DROPOUT:
            plain = zoo_predict(mt, without_dropout(mt, net), args, aux, x,
                                mt.gpu(0))
            row["inference_is_identity"] = bool(np.array_equal(probs, plain))
            if not row["inference_is_identity"]:
                fails.append(f"{name}: Dropout changed an inference")
        rows[name] = row
        torch.cuda.empty_cache()
    emit("zoo_predict", batch=2, images=3, dtype="float32", tf32=False,
         logit_tol=ZOO_LOGIT_TOL, softmax_tol=ZOO_SOFTMAX_TOL,
         networks=rows, failures=fails)
    if fails:
        raise RuntimeError("zoo_predict: " + "; ".join(fails))
    return vit_counts


# --------------------------------------------------------------------------
# Gluon: ResNet-50 v1 through gluon.Trainer, and the flash kernels through
# autograd.record()
# --------------------------------------------------------------------------
def gluon_resnet(mt, ctx, seed, hybridize=True, cast=None, classes=1000):
    """The model zoo's resnet50_v1, initialized on ``ctx`` (deferred
    shapes resolve at the first forward); hybridized with bf16 compute,
    or imperative and cast to ``cast``."""
    with mt.name.NameManager():
        net = mt.gluon.model_zoo.vision.resnet50_v1(classes=classes)
    mt.random.seed(seed)
    net.initialize(mt.initializer.Xavier(rnd_type="gaussian",
                                         magnitude=2.0), ctx=ctx)
    if cast is not None:
        net.cast(cast)
    if hybridize:
        net.hybridize(compute_dtype="bfloat16")
    return net


def gluon_batches(torch, mt, device, batch, shape, seed,
                  dtype="float32"):
    """Two synthetic batches made on ``device``: uniform(-1, 1) images in
    ``dtype`` and int32 labels in [0, 1000)."""
    gen = torch.Generator(device=device).manual_seed(seed)
    out = []
    for _ in range(2):
        x = torch.rand((batch,) + tuple(shape), generator=gen,
                       device=device) * 2 - 1
        y = torch.randint(0, 1000, (batch,), generator=gen, device=device,
                          dtype=torch.int32)
        out.append((mt.nd.NDArray(x.to(getattr(torch, dtype))),
                    mt.nd.NDArray(y)))
    return out


def gluon_train_steps(mt, net, trainer, loss_fn, batches, n, sync):
    """``n`` steps of record() -> loss(net(x), y) -> backward() ->
    trainer.step(batch) over the batches in turn, each ended by ``sync``:
    the ms of each step on the host clock and each step's mean loss (read
    once, after the last step)."""
    step_ms, losses = [], []
    for i in range(n):
        x, y = batches[i % len(batches)]
        t = time.monotonic()
        with mt.autograd.record():
            loss = loss_fn(net(x), y)
        loss.backward()
        trainer.step(x.shape[0])
        sync()
        step_ms.append((time.monotonic() - t) * 1e3)
        losses.append(loss.mean())
    return step_ms, [float(l.asscalar()) for l in losses]


def gluon_train_row(step_ms, losses, warmup, batch, peak_flops):
    timed_ms = step_ms[warmup:]
    med = float(np.median(timed_ms))
    flops = 2 * RESNET_FWD_MACS * 3 * batch
    tflops = flops / (med / 1e3) / 1e12
    first5, last5 = float(np.mean(losses[:5])), float(np.mean(losses[-5:]))
    return dict(first_step_ms=step_ms[0], warmup_ms=step_ms[:warmup],
                steps=len(timed_ms), step_ms=timed_ms, median_step_ms=med,
                min_step_ms=min(timed_ms), max_step_ms=max(timed_ms),
                images_per_s=batch / (med / 1e3), flops_per_step=flops,
                flops_source="analytic, bench.py:495: 2 x 4.1e9 "
                "multiply-adds a 224x224 image forward x 3 (forward and "
                "backward) x batch; v1 and v2 differ by under 1%",
                achieved_tflops=tflops, mfu=tflops * 1e12 / peak_flops,
                mfu_peak_tflops=peak_flops / 1e12, losses=losses,
                loss_first5_mean=first5, loss_last5_mean=last5)


def phase_gluon_resnet_train(torch, mt, peak_flops):
    """Gluon ResNet-50 v1 at ImageNet width, hybridized with bf16 compute,
    through gluon.Trainer on cuda:0: GLUON_WARMUP + GLUON_STEPS steps with
    the launch and dispatch counts reset just before and read just
    after."""
    dev = torch.device("cuda", 0)
    B, shape = GLUON_BATCH, (3, 224, 224)
    t0 = time.monotonic()
    net = gluon_resnet(mt, mt.gpu(0), SEED)
    trainer = mt.gluon.Trainer(net.collect_params(), "sgd", dict(GLUON_OPT))
    loss_fn = mt.gluon.loss.SoftmaxCrossEntropyLoss()
    batches = gluon_batches(torch, mt, dev, B, shape, SEED + 20)
    torch.cuda.synchronize()
    setup_s = time.monotonic() - t0

    # the Gluon ResNet path: counts start at 0 here and are read after
    torch.cuda.reset_peak_memory_stats()
    reset_counts(mt)
    n = GLUON_WARMUP + GLUON_STEPS
    step_ms, losses = gluon_train_steps(mt, net, trainer, loss_fn, batches,
                                        n, torch.cuda.synchronize)
    counts = read_counts(mt)
    dispatch = mt.profiler.dispatch_counts()
    peak = torch.cuda.max_memory_allocated()
    params = net.collect_params()
    n_params = sum(int(np.prod(p.shape)) for k, p in params.items()
                   if "running" not in k)
    row = gluon_train_row(step_ms, losses, GLUON_WARMUP, B, peak_flops)
    fails = []
    want = {"trainer.step": n, "autograd.backward": n,
            "gluon.cached_forward": n}
    if any(dispatch.get(k) != v for k, v in want.items()) \
            or any(counts.values()):
        fails.append(f"dispatches {dispatch} (want {want}) and attention "
                     f"launches {counts} (want none)")
    if not all(np.isfinite(losses)):
        fails.append(f"non-finite loss in {losses}")
    if not row["loss_last5_mean"] < row["loss_first5_mean"] - GLUON_MARGIN:
        fails.append(f"mean of the last 5 losses {row['loss_last5_mean']} "
                     f"does not beat the first 5's "
                     f"{row['loss_first5_mean']} by {GLUON_MARGIN}")
    dtypes = sorted({str(p.data().as_torch().dtype)
                     for p in params.values()})
    if dtypes != ["torch.float32"]:
        fails.append(f"parameter dtypes {dtypes}, want float32 masters")
    emit("gluon_resnet_train", model="resnet-50 v1 (gluon model zoo)",
         batch=B, image=list(shape), classes=1000, layout="NCHW",
         hybridized=True, compute_dtype="bfloat16", masters="float32",
         optimizer="gluon.Trainer sgd lr 0.1 momentum 0.9 wd 1e-4",
         initializer="xavier gaussian magnitude 2", n_params=n_params,
         cudnn_benchmark=torch.backends.cudnn.benchmark, setup_s=setup_s,
         peak_mem_bytes=peak, dispatches=dispatch,
         attention_launches=counts, margin=GLUON_MARGIN, failures=fails,
         **row)
    if fails:
        raise RuntimeError("gluon_resnet_train: " + "; ".join(fails))
    return net, trainer, loss_fn, batches, row["median_step_ms"]


def phase_gluon_resnet_profile(torch, mt, net, trainer, loss_fn, batches,
                               median_ms):
    """One more hybridized step under torch.profiler: the card's busy
    time, its idle share and the largest kernels."""
    x, y = batches[0]
    torch.cuda.synchronize()
    with device_window(torch) as prof:
        t = time.monotonic()
        with mt.autograd.record():
            loss = loss_fn(net(x), y)
        loss.backward()
        trainer.step(x.shape[0])
        torch.cuda.synchronize()
        prof_step_ms = (time.monotonic() - t) * 1e3
    kernels = device_kernels(prof)
    busy = sum(k[0] for k in kernels)
    if busy <= 0:
        raise RuntimeError("gluon_resnet_profile: the profile shows no "
                           "device time for a training step")
    bn = sum(k[0] for k in kernels if "batch_norm" in k[2].lower())
    emit("gluon_resnet_profile", step_ms=prof_step_ms, device_busy_ms=busy,
         device_idle_share_of_step=max(0.0, 1 - busy / prof_step_ms),
         device_idle_share_of_median_step=max(0.0, 1 - busy / median_ms),
         batch_norm_kernels_ms=bn,
         kernel_launches=sum(k[1] for k in kernels),
         top_kernels=[dict(ms=ms, count=c, name=k)
                      for ms, c, k in kernels[:12]])


def phase_gluon_resnet_imperative(torch, mt, peak_flops, hybrid_ms):
    """The same network and recipe, not hybridized: the JAX package's
    Gluon bf16 recipe is hybridize(compute_dtype=...), which has no
    imperative form, so the net is cast to bf16 (net.cast), its inputs
    are bf16 and the SGD keeps fp32 masters (multi_precision);
    GLUON_IMP_WARMUP + GLUON_IMP_STEPS steps."""
    dev = torch.device("cuda", 0)
    B, shape = GLUON_BATCH, (3, 224, 224)
    t0 = time.monotonic()
    net = gluon_resnet(mt, mt.gpu(0), SEED, hybridize=False,
                       cast="bfloat16")
    trainer = mt.gluon.Trainer(net.collect_params(), "sgd",
                               dict(GLUON_OPT, multi_precision=True))
    loss_fn = mt.gluon.loss.SoftmaxCrossEntropyLoss()
    batches = gluon_batches(torch, mt, dev, B, shape, SEED + 20,
                            dtype="bfloat16")
    torch.cuda.synchronize()
    setup_s = time.monotonic() - t0
    torch.cuda.reset_peak_memory_stats()
    reset_counts(mt)
    n = GLUON_IMP_WARMUP + GLUON_IMP_STEPS
    step_ms, losses = gluon_train_steps(mt, net, trainer, loss_fn, batches,
                                        n, torch.cuda.synchronize)
    counts = read_counts(mt)
    dispatch = mt.profiler.dispatch_counts()
    peak = torch.cuda.max_memory_allocated()
    row = gluon_train_row(step_ms, losses, GLUON_IMP_WARMUP, B, peak_flops)
    fails = []
    if dispatch.get("trainer.step") != n or "gluon.cached_forward" in \
            dispatch or any(counts.values()):
        fails.append(f"dispatches {dispatch} and attention launches "
                     f"{counts} (want {n} steps, no cached forward, no "
                     "attention)")
    if not all(np.isfinite(losses)):
        fails.append(f"non-finite loss in {losses}")
    emit("gluon_resnet_imperative", model="resnet-50 v1 (gluon model zoo)",
         batch=B, image=list(shape), hybridized=False,
         bf16_recipe="net.cast('bfloat16'), bf16 inputs, SGD "
         "multi_precision (fp32 masters)", setup_s=setup_s,
         peak_mem_bytes=peak, dispatches=dispatch,
         hybridized_median_step_ms=hybrid_ms,
         imperative_over_hybridized=row["median_step_ms"] / hybrid_ms,
         failures=fails, **row)
    if fails:
        raise RuntimeError("gluon_resnet_imperative: " + "; ".join(fails))
    del net, trainer, batches
    torch.cuda.empty_cache()


def gluon_numpy_params(mt, seed):
    """Seeded He-scaled resnet50_v1 weights by name, gamma near 1, small
    beta, running statistics near (0, 1), as numpy (the shapes from a
    CPU net's deferred initialization)."""
    net = gluon_resnet(mt, mt.cpu(), seed, hybridize=False)
    net(mt.nd.zeros((1,) + GLUON_FP32_IMAGE, ctx=mt.cpu()))
    rng = np.random.default_rng(seed)
    out = {}
    for name, p in net.collect_params().items():
        shape = p.shape
        if name.endswith("running_var"):
            x = rng.uniform(0.5, 1.5, shape)
        else:
            x = rng.standard_normal(shape)
            if name.endswith("_weight"):
                x *= np.sqrt(2.0 / np.prod(shape[1:]))
            elif name.endswith("_gamma"):
                x = 1 + 0.1 * x
            else:
                x *= 0.1
        out[name] = x.astype(np.float32)
    return out


def gluon_fp32_step(mt, ctx, values, x, y, hybridize, dtype="float32"):
    """One SGD-momentum step of resnet50_v1 from ``values`` on ``ctx``,
    in fp32 (float64 for the CPU rehearsal's reference): (loss,
    gradients, new parameters, seconds), as numpy."""
    net = gluon_resnet(mt, ctx, SEED, hybridize=False, cast=dtype)
    mt.convert.gluon_params_from_numpy(net.collect_params(), values, ctx)
    if hybridize:
        net.hybridize()
    trainer = mt.gluon.Trainer(net.collect_params(), "sgd", dict(GLUON_OPT))
    loss_fn = mt.gluon.loss.SoftmaxCrossEntropyLoss()
    xs = mt.nd.array(x, ctx=ctx, dtype=dtype)
    ys = mt.nd.array(y, ctx=ctx, dtype="int32")
    t0 = time.monotonic()
    with mt.autograd.record():
        loss = loss_fn(net(xs), ys)
    loss.backward()
    grads = {k: p.grad().asnumpy() for k, p in net.collect_params().items()
             if p.grad_req != "null"}
    trainer.step(x.shape[0])
    lval = float(loss.mean().asscalar())
    secs = time.monotonic() - t0
    return lval, grads, mt.convert.gluon_params_to_numpy(
        net.collect_params()), secs


def gluon_fp32_compare(card, cpu, values):
    """The budget's numbers for one card-vs-CPU pair of steps."""
    (gl, gg, gp, gs), (cl, cg, cp, cs) = card, cpu

    def rel(a, b):
        return float(np.abs(a - b).max() / max(np.abs(b).max(), 1e-30))

    def norm_rel(pairs):
        return float(np.sqrt(sum(((a - b) ** 2).sum() for a, b in pairs))
                     / np.sqrt(sum((b ** 2).sum() for _, b in pairs)))
    head = [k for k in cg if "dense" in k]
    upd = {k: (gp[k] - values[k], cp[k] - values[k]) for k in cg}
    aux = {k: rel(gp[k], cp[k]) for k in cp if "running" in k}
    worst_aux = max(aux, key=aux.get)
    return dict(loss_gpu=gl, loss_cpu=cl, loss_diff=abs(gl - cl),
                head_grad_rel_diff=max(rel(gg[k], cg[k]) for k in head),
                head_update_rel_diff=max(rel(*upd[k]) for k in head),
                grad_norm_rel_diff=norm_rel([(gg[k], cg[k]) for k in cg]),
                update_norm_rel_diff=norm_rel(list(upd.values())),
                worst_aux_rel_diff=aux[worst_aux], worst_aux=worst_aux,
                gpu_s=gs, cpu_s=cs,
                finite=bool(all(np.isfinite(v).all() for v in gp.values())))


def phase_gluon_fp32(torch, mt):
    """One fp32 step of resnet50_v1 at full depth and width (batch 2,
    224x224), the card (TF32 off) against the CPU from the same weights,
    hybridized and imperatively."""
    values = gluon_numpy_params(mt, SEED + 21)
    rng = np.random.default_rng(SEED + 22)
    x = rng.uniform(-1, 1, (GLUON_FP32_BATCH,) + GLUON_FP32_IMAGE) \
        .astype(np.float32)
    y = rng.integers(0, 1000, GLUON_FP32_BATCH).astype(np.int32)
    fails, rows = [], {}
    for hybridize in (True, False):
        key = "hybridized" if hybridize else "imperative"
        row = gluon_fp32_compare(
            gluon_fp32_step(mt, mt.gpu(0), values, x, y, hybridize),
            gluon_fp32_step(mt, mt.cpu(), values, x, y, hybridize), values)
        rows[key] = row
        for name, lim in (("loss_diff", GLUON_FP32_LOSS_TOL),
                          ("worst_aux_rel_diff", GLUON_FP32_AUX_RTOL),
                          ("head_grad_rel_diff", GLUON_FP32_HEAD_RTOL),
                          ("head_update_rel_diff", GLUON_FP32_HEAD_RTOL),
                          ("grad_norm_rel_diff", GLUON_FP32_NORM_RTOL),
                          ("update_norm_rel_diff", GLUON_FP32_NORM_RTOL)):
            if not row[name] <= lim:
                fails.append(f"{key} {name} {row[name]} beyond {lim}")
        if not row["finite"]:
            fails.append(f"{key}: non-finite parameters on the card")
    emit("gluon_fp32_card_vs_cpu", model="resnet-50 v1 full depth and "
         "width", cut=f"batch {GLUON_FP32_BATCH} (not 256)",
         image=list(GLUON_FP32_IMAGE),
         budget=dict(loss=GLUON_FP32_LOSS_TOL, aux=GLUON_FP32_AUX_RTOL,
                     head=GLUON_FP32_HEAD_RTOL, norm=GLUON_FP32_NORM_RTOL),
         failures=fails, **rows)
    if fails:
        raise RuntimeError("gluon_fp32_card_vs_cpu: " + "; ".join(fails))
    torch.cuda.empty_cache()


def attention_block(mt, prefix="attn_"):
    """A user HybridBlock at GPT-2 small's widths: Dense(3d) -> q, k, v
    (B, H, S, D) -> F.contrib.FlashAttention(causal) -> (B, S, d) ->
    Dense(d)."""
    gluon = mt.gluon
    d, heads = ATTN_D, ATTN_HEADS

    class CausalSelfAttention(gluon.HybridBlock):
        def __init__(self, **kwargs):
            super().__init__(**kwargs)
            with self.name_scope():
                self.qkv = gluon.nn.Dense(3 * d, flatten=False, in_units=d)
                self.proj = gluon.nn.Dense(d, flatten=False, in_units=d)

        def hybrid_forward(self, F, x):
            qkv = self.qkv(x).reshape((0, 0, 3, heads, d // heads))
            qkv = F.transpose(qkv, axes=(2, 0, 3, 1, 4))
            q, k, v = F.split(qkv, num_outputs=3, axis=0, squeeze_axis=True)
            o = F.contrib.FlashAttention(q, k, v, causal=True)
            o = F.transpose(o, axes=(0, 2, 1, 3)).reshape((0, 0, -3))
            return self.proj(o)

    with mt.name.NameManager():
        return CausalSelfAttention(prefix=prefix)


def attention_values(mt, seed):
    """Seeded N(0, 0.02) weights of the block, as numpy."""
    rng = np.random.default_rng(seed)
    net = attention_block(mt)
    return {name: (rng.standard_normal(p.shape) * 0.02).astype(np.float32)
            for name, p in net.collect_params().items()}


def attention_run(torch, mt, ctx, values, x, target, hybridize, dtype,
                  steps):
    """``steps`` of record() -> L2Loss(block(x), target) -> backward() ->
    Trainer.step on ``ctx``; (losses, output, input gradient, parameters
    after)."""
    net = attention_block(mt)
    net.initialize(ctx=ctx)
    mt.convert.gluon_params_from_numpy(net.collect_params(), values)
    if dtype == "bfloat16" and not hybridize:
        net.cast("bfloat16")
    if hybridize:
        net.hybridize(compute_dtype=dtype if dtype == "bfloat16" else None)
    trainer = mt.gluon.Trainer(net.collect_params(), "sgd",
                               {"learning_rate": 0.1})
    loss_fn = mt.gluon.loss.L2Loss()
    in_dtype = dtype if not hybridize else "float32"
    xs = mt.nd.array(x, ctx=ctx, dtype=in_dtype)
    ts = mt.nd.array(target, ctx=ctx, dtype=in_dtype)
    xs.attach_grad()
    losses = []
    for _ in range(steps):
        with mt.autograd.record():
            out = net(xs)
            loss = loss_fn(out, ts)
        loss.backward()
        trainer.step(x.shape[0])
        losses.append(loss.mean())
    return ([float(l.asscalar()) for l in losses], out.asnumpy(),
            xs.grad.asnumpy(), mt.convert.gluon_params_to_numpy(
                net.collect_params()))


def phase_gluon_attention(torch, mt):
    """K1-K3 through the imperative autograd: the attention block at
    GPT-2 small's widths under record() -> backward() -> Trainer.step, in
    bf16 imperatively and hybridized (counts reset just before each path,
    read just after: one K1 with lse, one K2 and one K3 a step), then the
    q/k/v gradients through nd.contrib.FlashAttention against the plain
    backward, a retained second backward and an input mutated after
    recording (card = CPU), and one fp32 step against the CPU."""
    from mxnet_tpu_torch.ops import attention as att
    B, S, d = ATTN_BATCH, ATTN_SEQ, ATTN_D
    rng = np.random.default_rng(SEED + 30)
    values = attention_values(mt, SEED + 31)
    x = rng.standard_normal((B, S, d)).astype(np.float32)
    target = rng.standard_normal((B, S, d)).astype(np.float32)
    fails, paths, rows = [], {}, {}
    per_step = {"flash_fwd": 1, "flash_fwd_lse": 1, "flash_bwd_dq": 1,
                "flash_bwd_dkv": 1, "nms_suppress": 0}
    for hybridize in (False, True):
        key = "gluon_attention_" + ("hybridized" if hybridize
                                    else "imperative")
        torch.cuda.synchronize()
        t0 = time.monotonic()
        # this path: counts start at 0 here and are read right after
        reset_counts(mt)
        losses, out, gx, _ = attention_run(
            torch, mt, mt.gpu(0), values, x, target, hybridize, "bfloat16",
            ATTN_STEPS)
        torch.cuda.synchronize()
        counts = read_counts(mt)
        secs = time.monotonic() - t0
        want = {k: v * ATTN_STEPS for k, v in per_step.items()}
        if counts != want:
            fails.append(f"{key}: launches {counts}, want {want}")
        if not (np.isfinite(losses).all() and np.isfinite(out).all()
                and np.isfinite(gx).all()):
            fails.append(f"{key}: non-finite loss, output or gradient")
        paths[key] = counts
        rows[key] = dict(losses=losses, launches=counts, seconds=secs,
                         input_grad_max_abs=float(np.abs(gx).max()))

    # q/k/v gradients through autograd against the plain backward, on
    # the block's own shapes (not counted: a comparison launch)
    dev = torch.device("cuda", 0)
    H, D = ATTN_HEADS, d // ATTN_HEADS
    qkv = [torch.from_numpy(rng.standard_normal((B, H, S, D), dtype=np.float32))
           .to(dev, torch.bfloat16) for _ in range(3)]
    g = torch.from_numpy(rng.standard_normal((B, H, S, D), dtype=np.float32)
                         ).to(dev, torch.bfloat16)
    arrs = [mt.nd.NDArray(t.clone()) for t in qkv]
    for a in arrs:
        a.attach_grad()
    with mt.autograd.record():
        o = mt.nd.contrib.FlashAttention(*arrs, causal=True)
    o.backward(out_grad=mt.nd.NDArray(g))
    # the plain backward from the same forward's out and lse (K1 again)
    out_k, lse = att.flash_fwd_cuda(*qkv, True, None, return_lse=True)
    ref = att._flash_bwd_reference(*qkv, out_k, lse, g, True, None)
    grad_err = {}
    for name, a, r in zip(("dq", "dk", "dv"), arrs, ref):
        got, want = a.grad.as_torch().float(), r.float()
        grad_err[name] = float((got - want).abs().max())
        if not torch.allclose(got, want, **BWD_TOL["bfloat16"]):
            fails.append(f"{name} through autograd: max error "
                         f"{grad_err[name]} beyond {BWD_TOL['bfloat16']}")

    # a retained second backward, and an input mutated after recording:
    # the card against the CPU, fp32 (B 1, S 256, full width)
    small_x = x[:1, :256]
    mut = {}
    for name, ctx in (("gpu", mt.gpu(0)), ("cpu", mt.cpu())):
        net = attention_block(mt)
        net.initialize(ctx=ctx)
        mt.convert.gluon_params_from_numpy(net.collect_params(), values)
        xs = mt.nd.array(small_x, ctx=ctx)
        xs.attach_grad()
        with mt.autograd.record():
            y = net(xs)
            loss = (y * y).sum()
        loss.backward(retain_graph=True)
        g1 = xs.grad.asnumpy().copy()
        xs += 1.0                    # mutated after recording
        loss.backward()
        mut[name] = (g1, xs.grad.asnumpy())
    (g1c, g2c), (g1h, g2h) = mut["gpu"], mut["cpu"]
    # the second backward repeats the first (a mutation that reached the
    # graph would move it by O(1)): within 1e-6 of the largest element
    mut_err = float(np.abs(g2c - g1c).max() / np.abs(g1c).max())
    mut_cpu = float(np.abs(g2h - g1h).max() / np.abs(g1h).max())
    mut_vs_cpu = float(np.abs(g2c - g2h).max() / np.abs(g2h).max())
    if mut_err > 1e-6 or mut_cpu > 1e-6 or mut_vs_cpu > ATTN_FP32_RTOL:
        fails.append(f"retained / mutated backward: second minus first "
                     f"{mut_err} (card), {mut_cpu} (CPU); card vs CPU "
                     f"{mut_vs_cpu}")

    # one fp32 step, card (TF32 off) against the CPU
    fp32 = {}
    for name, ctx in (("gpu", mt.gpu(0)), ("cpu", mt.cpu())):
        for hybridize in (False, True):
            fp32[(name, hybridize)] = attention_run(
                torch, mt, ctx, values, x[:ATTN_FP32_BATCH],
                target[:ATTN_FP32_BATCH], hybridize, "float32", 1)

    def rel(a, b):
        return float(np.abs(a - b).max() / max(np.abs(b).max(), 1e-30))
    fp32_rows = {}
    for hybridize in (False, True):
        (gl, go, ggx, gp), (cl, co, cgx, cp) = \
            fp32[("gpu", hybridize)], fp32[("cpu", hybridize)]
        upd = {k: (gp[k] - values[k], cp[k] - values[k]) for k in cp}
        scale = max(float(np.abs(c).max()) for _, c in upd.values())
        per_param = {k: float(np.abs(g - c).max()) / scale
                     for k, (g, c) in upd.items()}
        worst = max(per_param, key=per_param.get)
        r = dict(loss_gpu=gl[0], loss_cpu=cl[0], out_rel_diff=rel(go, co),
                 input_grad_rel_diff=rel(ggx, cgx),
                 update_rel_diff=per_param[worst], worst_param=worst,
                 update_scale=scale,
                 own_scale_rel_diff={k: rel(*upd[k]) for k in upd})
        fp32_rows["hybridized" if hybridize else "imperative"] = r
        for k in ("out_rel_diff", "input_grad_rel_diff", "update_rel_diff"):
            if not r[k] <= ATTN_FP32_RTOL:
                fails.append(f"fp32 {k} {r[k]} beyond {ATTN_FP32_RTOL}")
    emit("gluon_attention", block="Dense(3d) -> FlashAttention(causal) -> "
         "Dense(d)", d_model=d, heads=ATTN_HEADS, seq=S, batch=B,
         steps_per_path=ATTN_STEPS, bf16=rows, per_step_launches=per_step,
         qkv_grad_max_abs_err=grad_err, qkv_grad_tol=BWD_TOL["bfloat16"],
         retained_second_minus_first=dict(gpu=mut_err, cpu=mut_cpu),
         mutated_card_vs_cpu=mut_vs_cpu,
         fp32_card_vs_cpu=fp32_rows, fp32_rtol=ATTN_FP32_RTOL,
         failures=fails)
    if fails:
        raise RuntimeError("gluon_attention: " + "; ".join(fails))
    torch.cuda.empty_cache()
    return paths


# ---------------------------------------------------------------------------
# the user-kernel path: mx.rtc
# ---------------------------------------------------------------------------
def rtc_doubler(mt):
    """The two doublers compiled through rtc.CudaModule from their source
    in the checkout, and the op a user calls: rtc.CudaFunction over a
    closure that allocates the output and launches the vectorised kernel
    (``doubler_vec4``: float4 accesses in a grid-stride loop, a grid of
    RTC_VECTORS_PER_THREAD vectors a thread).  Returns (vec4 kernel, its
    launch, the op, the one-thread-an-element kernel's launch)."""
    import torch
    root = os.path.dirname(os.path.abspath(__file__))
    with open(os.path.join(root, RTC_SOURCE)) as f:
        source = f.read()
    module = mt.rtc.CudaModule(source)
    sig = "const float* x, float* y, int n"
    kernel = module.get_kernel("doubler_vec4", sig)
    scalar = module.get_kernel("doubler", sig)
    per_block = RTC_BLOCK * RTC_VECTORS_PER_THREAD

    def launch(x):
        y = torch.empty_like(x)
        n = x.numel()
        blocks = max(1, (n // 4 + per_block - 1) // per_block)
        kernel.launch([x, y, n], mt.gpu(x.device.index or 0), (blocks,),
                      (RTC_BLOCK,))
        return y

    def launch_scalar(x):
        y = torch.empty_like(x)
        n = x.numel()
        scalar.launch([x, y, n], mt.gpu(x.device.index or 0),
                      ((n + RTC_BLOCK - 1) // RTC_BLOCK,), (RTC_BLOCK,))
        return y
    return kernel, launch, mt.rtc.CudaFunction(launch, name="doubler"), \
        launch_scalar


def phase_rtc(torch, mt):
    """Compile the doublers, drive the vectorised one as a user would (an
    NDArray on the card through the op wrapper, twice, counts reset just
    before), hold both results bit for bit against x * 2 (and the kernel
    on lengths with 1-3 trailing elements), and time it beside the first
    design (one thread an element), its bound, the plain version and
    torch.mul."""
    t0 = time.monotonic()
    kernel, launch, op, launch_scalar = rtc_doubler(mt)
    build_s = time.monotonic() - t0
    gen = torch.Generator(device="cuda").manual_seed(SEED + 40)
    x = torch.randn(RTC_SHAPE, generator=gen, device="cuda")
    xa = mt.nd.NDArray(x)
    kernel.launches = 0
    y1 = op(xa)
    y2 = op(xa)
    launches = kernel.launches
    torch.cuda.synchronize()
    want = x * 2
    equal = torch.equal(y1._data, want) and torch.equal(y2._data, want)
    err = float((y1._data - want).abs().max())
    tails = {n: torch.equal(launch(x.reshape(-1)[:n]), 2 * x.reshape(-1)[:n])
             for n in (1, 5, 1027, 4099)}
    scalar_equal = torch.equal(launch_scalar(x), want)
    if launches != 2 or not equal or not all(tails.values()) \
            or not scalar_equal:
        raise RuntimeError(f"rtc: {launches} launches (want 2), equal to "
                           f"x * 2: {equal}, max |diff| {err}, tails "
                           f"{tails}, first design equal: {scalar_equal}")
    row = dict(shape=list(RTC_SHAPE), dtype="float32", build_s=build_s,
               launches=launches, bit_identical=equal,
               bit_identical_relaunch=torch.equal(y1._data, y2._data),
               tails_bit_identical={str(k): v for k, v in tails.items()},
               max_abs_err=err, library_so=kernel.path)
    nbytes = 2 * x.numel() * 4
    timed(row, "kernel_ms", lambda: launch(x))
    timed(row, "scalar_kernel_ms", lambda: launch_scalar(x))
    timed(row, "plain_ms", lambda: x * 2)
    timed(row, "library_ms", lambda: torch.mul(x, 2))
    row.update(bytes=nbytes, bound_ms=nbytes / PEAK_BYTES_PER_S * 1e3,
               bound_by="bytes")
    fails = []
    check_bound_share(row, "kernel_ms", fails, "rtc doubler")
    emit("rtc", **row)
    if fails:
        raise RuntimeError("rtc: " + "; ".join(fails))
    return row


# ---------------------------------------------------------------------------
# the RNN family: benchmark/rnn_bench.py through Module, PTB bucketing,
# the Gluon LSTM
# ---------------------------------------------------------------------------
def rnn_lm_sym(mt):
    """rnn_bench.py's build_sym over the port: Embedding -> FusedRNNCell
    (one RNN op, layout NTC) -> FullyConnected(vocab) -> SoftmaxOutput."""
    sym = mt.sym
    cell = mt.rnn.FusedRNNCell(RNN["hidden"], num_layers=RNN["layers"],
                               mode="lstm", prefix="lstm_")
    embed = sym.Embedding(sym.Variable("data"), input_dim=RNN["vocab"],
                          output_dim=RNN["embed"], name="embed")
    out, _ = cell.unroll(RNN["seq"], inputs=embed, merge_outputs=True,
                         layout="NTC")
    pred = sym.FullyConnected(sym.Reshape(out, shape=(-1, RNN["hidden"])),
                              num_hidden=RNN["vocab"], name="pred")
    lab = sym.Reshape(sym.Variable("softmax_label"), shape=(-1,))
    return sym.SoftmaxOutput(pred, lab, name="softmax")


def rnn_module(mt, ctx, compute_dtype=None, batch=None, arg_params=None):
    """rnn_bench.py's Module: int32 ids and labels, Xavier (seeded) or
    ``arg_params``, SGD lr 1.0 momentum 0.9."""
    B, T = batch or RNN["batch"], RNN["seq"]
    mod = mt.mod.Module(rnn_lm_sym(mt), context=ctx,
                        compute_dtype=compute_dtype)
    mod.bind([mt.io.DataDesc("data", (B, T), np.int32)],
             [mt.io.DataDesc("softmax_label", (B, T), np.int32)])
    mt.random.seed(SEED)
    mod.init_params(mt.initializer.Xavier(), arg_params=arg_params)
    mod.init_optimizer(optimizer="sgd", optimizer_params=dict(RNN_OPT))
    return mod


def rnn_batches(torch, mt, device, batch, seed):
    """Two batches of int32 ids and labels made on ``device``: a uniform
    random first token a row, then next = (3 * token + 1) % vocab (the
    rule of lm_batch, which a model can learn), labels the next tokens.
    rnn_bench.py draws its ids and labels uniformly, which times the same
    work but gives a loss that only wanders under lr 1.0 (PERF.md §6)."""
    gen = torch.Generator(device=device).manual_seed(seed)
    V, T = RNN["vocab"], RNN["seq"]
    out = []
    for _ in range(2):
        toks = [torch.randint(0, V, (batch,), generator=gen, device=device,
                              dtype=torch.int64)]
        for _ in range(T):
            toks.append((3 * toks[-1] + 1) % V)
        toks = torch.stack(toks, 1).to(torch.int32)
        out.append(mt.io.DataBatch([mt.nd.NDArray(toks[:, :-1].contiguous())],
                                   [mt.nd.NDArray(toks[:, 1:].contiguous())]))
    return out


def rnn_split(torch, mt):
    """Where an LSTM step's card time goes, part by part, each timed
    alone at the step's shapes in bf16 (the fp32 softmax as the executor
    runs it): the fused RNN forward + backward (cuDNN), the copy of its
    weights into cuDNN's order that cuDNN makes on every call (the same
    bytes, by torch.cat of the flat vector's views), the vocab
    projection forward + backward, SoftmaxOutput and its gradient."""
    from mxnet_tpu_torch.ops import rnn as rnn_ops
    from mxnet_tpu_torch.ops import registry
    dev, bf = torch.device("cuda", 0), torch.bfloat16
    B, T, H, E, V, L = (RNN[k] for k in ("batch", "seq", "hidden", "embed",
                                         "vocab", "layers"))
    gen = torch.Generator(device=dev).manual_seed(SEED + 50)

    def rnd(*shape, dtype=bf):
        return (torch.randn(shape, generator=gen, device=dev) * 0.05) \
            .to(dtype).requires_grad_()
    n = rnn_ops.rnn_param_size(L, E, H, False, "lstm")
    flat, x = rnd(n), rnd(T, B, E)
    h0 = torch.zeros(L, 1, H, device=dev)
    rnn_fn = registry.get("RNN").fn

    def rnn_step():
        out = rnn_fn(x, flat, h0, h0, state_size=H, num_layers=L,
                     mode="lstm", is_train=True)[0]
        torch.autograd.grad(out, [x, flat], torch.ones_like(out))
    views = [w for layer in rnn_ops.unpack_flat(flat.detach(), L, E, H, 1, 4)
             for per_dir in layer for w in per_dir]
    hid, w = rnd(B * T, H), rnd(V, H)

    def projection():
        out = torch.nn.functional.linear(hid, w)
        torch.autograd.grad(out, [hid, w], torch.ones_like(out))
    logits = rnd(B * T, V, dtype=torch.float32)
    lab = torch.randint(0, V, (B * T,), generator=gen, device=dev,
                        dtype=torch.int32)
    sm = registry.get("SoftmaxOutput").fn

    def softmax():
        out = sm(logits, lab)
        torch.autograd.grad(out, [logits], torch.ones_like(out))
    row = {}
    timed(row, "cudnn_rnn_fwd_bwd_ms", rnn_step, iters=5)
    timed(row, "weight_repack_ms",
          lambda: torch.cat([v.reshape(-1) for v in views]))
    timed(row, "vocab_projection_fwd_bwd_ms", projection, iters=5)
    timed(row, "softmax_output_fwd_grad_ms", softmax, iters=5)
    row["weight_repack_bytes"] = 2 * n * 2
    return row


def phase_rnn_train(torch, mt, peak_flops):
    """rnn_bench.py's configuration through the port's Module: setup,
    the first step, RNN_WARMUP + RNN_STEPS steps over two batches with
    the counts reset just before and read just after, tokens/s, TFLOP/s
    on the analytic count, MFU, peak memory; then one profiled step, the
    optimizer alone, and the step's parts timed alone (rnn_split)."""
    dev = torch.device("cuda", 0)
    B, T = RNN["batch"], RNN["seq"]
    t0 = time.monotonic()
    mod = rnn_module(mt, mt.gpu(0), "bfloat16")
    batches = rnn_batches(torch, mt, dev, B, SEED + 41)
    torch.cuda.synchronize()
    setup_s = time.monotonic() - t0
    n_params = sum(int(np.prod(a.shape))
                   for a in mod.get_params()[0].values())

    torch.cuda.reset_peak_memory_stats()
    reset_counts(mt)
    n = RNN_WARMUP + RNN_STEPS
    step_ms, losses = resnet_steps(mt, mod, batches, n,
                                   torch.cuda.synchronize)
    counts = read_counts(mt)
    dispatch = mt.profiler.dispatch_counts()
    peak = torch.cuda.max_memory_allocated()
    if any(counts.values()) or dispatch.get("module.update") != n \
            or dispatch.get("module.backward") != n:
        raise RuntimeError(f"rnn_train: launches {counts} (want none: no "
                           f"hand-written kernel is on this path) / "
                           f"dispatches {dispatch}, want {n} updates and "
                           "backwards")
    first5, last5 = float(np.mean(losses[:5])), float(np.mean(losses[-5:]))
    if not all(np.isfinite(losses)) or not last5 < first5 - RNN_MARGIN:
        raise RuntimeError(f"rnn_train: losses {losses}: the last 5 "
                           f"({last5}) do not beat the first 5 ({first5}) "
                           f"by {RNN_MARGIN}")
    out = mod.get_outputs()[0]
    if out.shape != (B * T, RNN["vocab"]) or \
            not bool(torch.isfinite(out._data).all()):
        raise RuntimeError(f"rnn_train: output {out.shape} not finite")
    timed_ms = step_ms[RNN_WARMUP:]
    med = float(np.median(timed_ms))
    tokens = B * T
    flops = RNN_FLOPS_PER_TOKEN * tokens
    tflops = flops / (med / 1e3) / 1e12

    # one step under the profiler
    torch.cuda.synchronize()
    with device_window(torch) as prof:
        t = time.monotonic()
        mod.forward(batches[0], is_train=True)
        mod.update()
        torch.cuda.synchronize()
        prof_ms = (time.monotonic() - t) * 1e3
    kernels = device_kernels(prof)
    busy = sum(k[0] for k in kernels)
    # the optimizer alone: the update after a synchronized backward
    upd = []
    for b in batches * 2:
        mod.forward(b, is_train=True)
        mod.backward()
        torch.cuda.synchronize()
        t = time.monotonic()
        mod.update()
        torch.cuda.synchronize()
        upd.append((time.monotonic() - t) * 1e3)
    split = rnn_split(torch, mt)
    emit("rnn_train", model="lstm-ptb-medium (rnn_bench.py)", **RNN,
         compute_dtype="bfloat16", masters="float32",
         optimizer=RNN_OPT, initializer="xavier",
         n_params=n_params, setup_s=setup_s, first_step_ms=step_ms[0],
         warmup_ms=step_ms[:RNN_WARMUP], steps=len(timed_ms),
         step_ms=timed_ms, median_step_ms=med, min_step_ms=min(timed_ms),
         max_step_ms=max(timed_ms), tokens_per_s=tokens / (med / 1e3),
         flops_per_token=RNN_FLOPS_PER_TOKEN, flops_per_step=flops,
         flops_source="analytic, benchmark/rnn_bench.py:137-149",
         achieved_tflops=tflops, mfu=tflops * 1e12 / peak_flops,
         mfu_peak_tflops=peak_flops / 1e12, peak_mem_bytes=peak,
         losses=losses, loss_first5_mean=first5, loss_last5_mean=last5,
         margin=RNN_MARGIN, launches=counts, dispatches=dispatch)
    emit("rnn_profile", step_ms=prof_ms, device_busy_ms=busy,
         device_idle_share_of_step=max(0.0, 1 - busy / prof_ms),
         device_idle_share_of_median_step=max(0.0, 1 - busy / med),
         host_ms_of_median_step=max(0.0, med - busy),
         update_ms=float(np.median(upd)), update_ms_min=min(upd),
         update_ms_max=max(upd), **split,
         top_kernels=[dict(ms=ms, count=c, name=k)
                      for ms, c, k in kernels[:15]])
    del mod, batches, out
    torch.cuda.empty_cache()
    return med, counts


def rnn_numpy_params(mt, seed):
    """Seeded Xavier weights of the rnn_bench model, as numpy, made on
    the CPU (the same on every machine)."""
    mod = mt.mod.Module(rnn_lm_sym(mt), context=mt.cpu())
    mod.bind([mt.io.DataDesc("data", (1, RNN["seq"]), np.int32)],
             [mt.io.DataDesc("softmax_label", (1, RNN["seq"]), np.int32)])
    mt.random.seed(seed)
    mod.init_params(mt.initializer.Xavier())
    return {n: a.asnumpy() for n, a in mod.get_params()[0].items()}


def rnn_numpy_batch(seed, batch):
    rng = np.random.default_rng(seed)
    return (rng.integers(0, RNN["vocab"], (batch, RNN["seq"]),
                         dtype=np.int32),
            rng.integers(0, RNN["vocab"], (batch, RNN["seq"]),
                         dtype=np.int32))


def rnn_fp32_step(mt, ctx, params, x, y):
    """One fp32 Module step (SGD with momentum: the first update is -lr x
    the gradient / batch) from ``params`` on (x, y): (loss, {name:
    update})."""
    mod = rnn_module(mt, ctx, batch=x.shape[0], arg_params=params)
    batch = mt.io.DataBatch([mt.nd.array(x, ctx=mt.cpu())],
                            [mt.nd.array(y, ctx=mt.cpu())])
    mod.forward(batch, is_train=True)
    mod.update()
    metric = mt.metric.CrossEntropy()
    mod.update_metric(metric, batch.label)
    new = {n: a.asnumpy() for n, a in mod.get_params()[0].items()}
    return metric.get()[1], {n: new[n] - params[n] for n in params}


def update_rel_diffs(a, b):
    """{name: max |a - b| over max |b|} of two update dicts."""
    return {n: float(np.abs(a[n] - b[n]).max()
                     / max(float(np.abs(b[n]).max()), 1e-30)) for n in b}


def phase_rnn_fp32(torch, mt):
    """One fp32 step of rnn_bench.py's model at full width and batch,
    card (cuDNN, TF32 off) against the CPU, from the same weights."""
    params = rnn_numpy_params(mt, SEED + 42)
    x, y = rnn_numpy_batch(SEED + 43, RNN["batch"])
    t0 = time.monotonic()
    gl, gu = rnn_fp32_step(mt, mt.gpu(0), params, x, y)
    gs = time.monotonic() - t0
    t0 = time.monotonic()
    cl, cu = rnn_fp32_step(mt, mt.cpu(), params, x, y)
    cs = time.monotonic() - t0
    rel = update_rel_diffs(gu, cu)
    worst = max(rel, key=rel.get)
    if not np.isfinite(gl) or abs(gl - cl) > RNN_FP32_LOSS_TOL \
            or rel[worst] > RNN_FP32_UPDATE_RTOL \
            or not all(np.isfinite(v).all() for v in gu.values()):
        raise RuntimeError(f"rnn fp32: loss {gl} card, {cl} CPU (tol "
                           f"{RNN_FP32_LOSS_TOL}); update diffs {rel} "
                           f"(tol {RNN_FP32_UPDATE_RTOL})")
    emit("rnn_fp32_card_vs_cpu", batch=RNN["batch"], loss_gpu=gl,
         loss_cpu=cl, loss_tol=RNN_FP32_LOSS_TOL, update_rel_diff=rel,
         worst_param=worst, update_rtol=RNN_FP32_UPDATE_RTOL, gpu_s=gs,
         cpu_s=cs)
    torch.cuda.empty_cache()


def synthetic_corpus(n=600, vocab_size=60, seed=0):
    """examples/rnn/train_ptb.py's synthetic_corpus (copied: the example
    imports the JAX package): a Markov-chain corpus, next token =
    (token * 3 + 1) % V with noise, sentences of 8-24 tokens."""
    rng = np.random.RandomState(seed)
    sentences = []
    for _ in range(n):
        ln = rng.randint(8, 25)
        s = [int(rng.randint(2, vocab_size))]
        for _ in range(ln - 1):
            if rng.rand() < 0.85:
                s.append((s[-1] * 3 + 1) % (vocab_size - 2) + 2)
            else:
                s.append(int(rng.randint(2, vocab_size)))
        sentences.append(s)
    return sentences, vocab_size


def ptb_sym_gen(mt, cfg):
    """train_ptb.py's sym_gen_factory over the port (per-bucket graph of
    unfused LSTMCells in a SequentialRNNCell)."""
    sym = mt.sym

    def sym_gen(seq_len):
        embed = sym.Embedding(sym.Variable("data"), input_dim=cfg["vocab"],
                              output_dim=cfg["embed"], name="embed")
        stack = mt.rnn.SequentialRNNCell()
        for i in range(cfg["layers"]):
            stack.add(mt.rnn.LSTMCell(num_hidden=cfg["hidden"],
                                      prefix="lstm_l%d_" % i))
        outputs, _ = stack.unroll(seq_len, inputs=embed, merge_outputs=True)
        pred = sym.FullyConnected(
            sym.Reshape(outputs, shape=(-1, cfg["hidden"])),
            num_hidden=cfg["vocab"], name="pred")
        lab = sym.Reshape(sym.Variable("softmax_label"), shape=(-1,))
        return (sym.SoftmaxOutput(data=pred, label=lab, name="softmax"),
                ("data",), ("softmax_label",))
    return sym_gen


def ptb_fit(mt, ctx, cfg, compute_dtype, sync):
    """One epoch of BucketingModule.fit over BucketSentenceIter
    (int32), as train_ptb.py runs it; per batch (a batch_end_callback,
    ended by ``sync``): its bucket, wall ms and mean negative
    log-probability (from the Perplexity metric's running sums), and the
    id of the bucket's executor."""
    import random
    random.seed(SEED)
    np.random.seed(SEED)
    sentences, _ = synthetic_corpus(cfg["sentences"], cfg["corpus_vocab"],
                                    SEED)
    it = mt.rnn.BucketSentenceIter(sentences, cfg["batch"],
                                   buckets=list(cfg["buckets"]),
                                   dtype="int32")
    mod = mt.mod.BucketingModule(ptb_sym_gen(mt, cfg),
                                 default_bucket_key=it.default_bucket_key,
                                 context=ctx, compute_dtype=compute_dtype)
    # the pad label (BucketSentenceIter's invalid_label, -1) left out: the
    # example's Perplexity(ignore_label=None) counts each pad as class
    # 9999 (labels are taken modulo the vocab), whose probability the
    # training drives down, so its perplexity rises with the pads' share
    metric = mt.metric.Perplexity(ignore_label=-1)
    rows, last = [], {"t": None, "sum": 0.0, "num": 0}

    def on_batch(param):
        sync()
        now = time.monotonic()
        metric.get()  # folds the pending sums in
        batch = param.locals["data_batch"]
        d_sum = metric.sum_metric - last["sum"]
        d_num = metric.num_inst - last["num"]
        rows.append(dict(bucket=batch.bucket_key,
                         ms=(now - last["t"]) * 1e3,
                         nll=float(d_sum) / max(int(d_num), 1),
                         executor=id(mod._curr_module._exec)))
        last.update(t=now, sum=metric.sum_metric, num=metric.num_inst)
    mt.random.seed(SEED)
    last["t"] = time.monotonic()
    mod.fit(it, num_epoch=1, eval_metric=metric, optimizer="sgd",
            optimizer_params=dict(PTB_OPT),
            initializer=mt.initializer.Xavier(),
            batch_end_callback=on_batch)
    return mod, rows, metric


def phase_ptb_bucketing(torch, mt):
    """train_ptb.py's path at PTB-medium widths on the card: every bucket
    bound once, over one set of parameters and one optimizer, perplexity
    falling over the epoch, wall ms a batch per bucket."""
    t0 = time.monotonic()
    reset_counts(mt)
    mod, rows, metric = ptb_fit(mt, mt.gpu(0), PTB, "bfloat16",
                                torch.cuda.synchronize)
    secs = time.monotonic() - t0
    counts = read_counts(mt)
    dispatch = mt.profiler.dispatch_counts()
    buckets = mod._buckets
    default = buckets[max(PTB["buckets"])]
    params = default._param_names
    shared = all(b._exec.arg_dict[n] is default._exec.arg_dict[n]
                 for b in buckets.values() for n in params)
    one_updater = all(b._updater is default._updater
                      for b in buckets.values())
    execs = {}
    for r in rows:
        execs.setdefault(r["bucket"], set()).add(r["executor"])
    nll = [r["nll"] for r in rows]
    w = PTB_WINDOW
    first, last = float(np.mean(nll[:w])), float(np.mean(nll[-w:]))
    per_bucket = {}
    for key in sorted(execs):
        ms = [r["ms"] for r in rows if r["bucket"] == key]
        # a bucket's first batch binds it: timed apart
        per_bucket[str(key)] = dict(
            batches=len(ms), first_ms=ms[0],
            median_ms=float(np.median(ms[1:])) if len(ms) > 1 else None,
            min_ms=min(ms[1:]) if len(ms) > 1 else None,
            max_ms=max(ms[1:]) if len(ms) > 1 else None,
            tokens_per_s=(PTB["batch"] * key / float(np.median(ms[1:]))
                          * 1e3) if len(ms) > 1 else None)
    problems = []
    if any(counts.values()):
        problems.append(f"launches {counts}: no hand-written kernel is on "
                        "this path")
    if sorted(buckets) != sorted(PTB["buckets"]):
        problems.append(f"buckets bound {sorted(buckets)}")
    if any(len(v) != 1 for v in execs.values()):
        problems.append("a bucket was bound more than once")
    if not shared or not one_updater:
        problems.append(f"shared parameters {shared}, one updater "
                        f"{one_updater}")
    if dispatch.get("module.update") != len(rows):
        problems.append(f"{dispatch.get('module.update')} updates for "
                        f"{len(rows)} batches")
    if not np.isfinite(nll).all() or not last < first - PTB_MARGIN:
        problems.append(f"mean NLL of the last {w} batches {last} does "
                        f"not beat the first {w}'s {first} by {PTB_MARGIN}")
    emit("ptb_bucketing", example="examples/rnn/train_ptb.py", **PTB,
         compute_dtype="bfloat16", optimizer=PTB_OPT, seconds=secs,
         batches=len(rows), buckets_bound=sorted(buckets),
         shared_parameters=shared, one_updater=one_updater,
         per_bucket=per_bucket, perplexity_first=float(np.exp(first)),
         perplexity_last=float(np.exp(last)), nll_first=first,
         nll_last=last, margin=PTB_MARGIN,
         epoch_perplexity=metric.get()[1], launches=counts,
         dispatches=dispatch, nll=nll)
    if problems:
        raise RuntimeError("ptb_bucketing: " + "; ".join(problems))
    del mod
    torch.cuda.empty_cache()
    return counts


def gluon_lm(mt, ctx, cfg=None, prefix="lm_"):
    """nn.Embedding -> gluon.rnn.LSTM -> nn.Dense(vocab), at rnn_train's
    widths, Xavier (seeded)."""
    cfg = cfg or RNN
    gluon = mt.gluon
    net = gluon.nn.HybridSequential(prefix=prefix)
    with net.name_scope():
        net.add(gluon.nn.Embedding(cfg["vocab"], cfg["embed"]))
        net.add(gluon.rnn.LSTM(cfg["hidden"], num_layers=cfg["layers"],
                               layout="NTC", input_size=cfg["embed"]))
        net.add(gluon.nn.Dense(cfg["vocab"], flatten=False,
                               in_units=cfg["hidden"]))
    mt.random.seed(SEED)
    net.initialize(mt.initializer.Xavier(), ctx=ctx)
    return net


def gluon_lm_steps(torch, mt, hybridize, batches, sync):
    """GLUON_LM_WARMUP + GLUON_LM_STEPS Trainer steps of the Gluon LM on
    the card, bf16 (hybridized with compute_dtype, or net.cast with
    multi_precision): step ms and losses, counts read around them."""
    net = gluon_lm(mt, mt.gpu(0))
    opt = dict(GLUON_LM_OPT)
    if hybridize:
        net.hybridize(compute_dtype="bfloat16")
    else:
        net.cast("bfloat16")
        opt["multi_precision"] = True
    trainer = mt.gluon.Trainer(net.collect_params(), "sgd", opt)
    pairs = [(b.data[0], b.label[0]) for b in batches]
    reset_counts(mt)
    step_ms, losses = gluon_train_steps(
        mt, net, trainer, gluon_lm_loss(mt), pairs,
        GLUON_LM_WARMUP + GLUON_LM_STEPS, sync)
    return step_ms, [l / RNN["seq"] for l in losses], read_counts(mt), \
        mt.profiler.dispatch_counts()


def gluon_lm_loss(mt):
    """Softmax cross-entropy summed over the sequence (see
    GLUON_LM_OPT)."""
    return mt.gluon.loss.SoftmaxCrossEntropyLoss(weight=RNN["seq"])


def phase_gluon_lstm(torch, mt, rnn_ms):
    """The Gluon LM on rnn_train's batches, hybridized and imperatively:
    losses finite and falling by GLUON_LM_MARGIN, one Trainer step and
    (hybridized) one cached forward a step, no hand-written kernel."""
    dev = torch.device("cuda", 0)
    batches = rnn_batches(torch, mt, dev, RNN["batch"], SEED + 41)
    out, problems = {}, []
    n = GLUON_LM_WARMUP + GLUON_LM_STEPS
    for name, hyb in (("hybridized", True), ("imperative", False)):
        torch.cuda.reset_peak_memory_stats()
        step_ms, losses, counts, dispatch = gluon_lm_steps(
            torch, mt, hyb, batches, torch.cuda.synchronize)
        timed_ms = step_ms[GLUON_LM_WARMUP:]
        med = float(np.median(timed_ms))
        out[name] = dict(first_step_ms=step_ms[0], step_ms=timed_ms,
                         median_step_ms=med, min_step_ms=min(timed_ms),
                         max_step_ms=max(timed_ms),
                         tokens_per_s=RNN["batch"] * RNN["seq"] / med * 1e3,
                         over_rnn_train=med / rnn_ms, losses=losses,
                         peak_mem_bytes=torch.cuda.max_memory_allocated(),
                         launches=counts, dispatches=dispatch)
        if any(counts.values()) or dispatch.get("trainer.step") != n or \
                (hyb and dispatch.get("gluon.cached_forward") != n):
            problems.append(f"{name}: launches {counts}, dispatches "
                            f"{dispatch} over {n} steps")
        first3, last3 = np.mean(losses[:3]), np.mean(losses[-3:])
        if not np.isfinite(losses).all() or \
                not last3 < first3 - GLUON_LM_MARGIN:
            problems.append(f"{name}: losses {losses}: the last 3 do not "
                            f"beat the first 3 by {GLUON_LM_MARGIN}")
        torch.cuda.empty_cache()
    emit("gluon_lstm", **RNN, optimizer=GLUON_LM_OPT,
         margin=GLUON_LM_MARGIN, rnn_train_median_step_ms=rnn_ms, **out)
    if problems:
        raise RuntimeError("gluon_lstm: " + "; ".join(problems))
    return {"gluon_lstm_" + k: v["launches"] for k, v in out.items()}


def gluon_lm_fp32_step(mt, ctx, values, x, y, hybridize, dtype="float32"):
    """One SGD step (GLUON_LM_OPT) of the Gluon LM from ``values``:
    (loss, {name: update})."""
    net = gluon_lm(mt, ctx)
    if dtype != "float32":
        net.cast(dtype)
    mt.convert.gluon_params_from_numpy(net.collect_params(), values)
    if hybridize:
        net.hybridize()
    trainer = mt.gluon.Trainer(net.collect_params(), "sgd",
                               dict(GLUON_LM_OPT))
    with mt.autograd.record():
        loss = gluon_lm_loss(mt)(
            net(mt.nd.array(x, ctx=ctx, dtype=np.int32)),
            mt.nd.array(y, ctx=ctx, dtype=np.int32))
    loss.backward()
    trainer.step(x.shape[0])
    new = mt.convert.gluon_params_to_numpy(net.collect_params())
    return float(loss.mean().asscalar()) / RNN["seq"], \
        {k: new[k].astype(np.float64) - values[k] for k in values}


def phase_gluon_lstm_fp32(torch, mt):
    """One fp32 Gluon LM step at full width, batch GLUON_LM_FP32_BATCH,
    card (cuDNN, TF32 off) against the CPU, hybridized and
    imperatively."""
    values = mt.convert.gluon_params_to_numpy(
        gluon_lm(mt, mt.cpu()).collect_params())
    x, y = rnn_numpy_batch(SEED + 44, GLUON_LM_FP32_BATCH)
    out = {}
    for hyb in (True, False):
        gl, gu = gluon_lm_fp32_step(mt, mt.gpu(0), values, x, y, hyb)
        cl, cu = gluon_lm_fp32_step(mt, mt.cpu(), values, x, y, hyb)
        rel = update_rel_diffs(gu, cu)
        worst = max(rel, key=rel.get)
        name = "hybridized" if hyb else "imperative"
        out[name] = dict(loss_gpu=gl, loss_cpu=cl, worst_param=worst,
                         worst_update_rel_diff=rel[worst])
        if not np.isfinite(gl) or abs(gl - cl) > GLUON_LM_FP32_LOSS_TOL \
                or rel[worst] > GLUON_LM_FP32_UPDATE_RTOL:
            raise RuntimeError(f"gluon lstm fp32 {name}: loss {gl} card, "
                               f"{cl} CPU; update diffs {rel}")
    emit("gluon_lstm_fp32_card_vs_cpu", batch=GLUON_LM_FP32_BATCH,
         loss_tol=GLUON_LM_FP32_LOSS_TOL,
         update_rtol=GLUON_LM_FP32_UPDATE_RTOL, **out)
    torch.cuda.empty_cache()


# ---------------------------------------------------------------------------
# the NMS suppression-matrix kernel (csrc/nms_overlap.cu)
# ---------------------------------------------------------------------------
def nms_case_inputs(torch, n, k, dtype, rule, classes, invalid, seed):
    """Sorted-by-score stand-ins for NMS: boxes in clusters of 8 (centres
    jittered by a few percent of the image, sides 5-40%), a share
    ``invalid`` of them invalid, classes 0-19 (or none); pixel boxes on a
    600 x 800 image."""
    dev = torch.device("cuda", 0)
    gen = torch.Generator(device=dev).manual_seed(seed)

    def u(*shape):
        return torch.rand(shape, generator=gen, device=dev)
    centre = u(n, k // 8 + 1, 1, 2).expand(-1, -1, 8, -1).reshape(n, -1, 2)
    centre = centre[:, :k] + (u(n, k, 2) - 0.5) * 0.06
    half = (0.05 + u(n, k, 2) * 0.35) / 2
    boxes = torch.cat([centre - half, centre + half], dim=-1).clamp(0, 1)
    if rule == "pixel":
        boxes = torch.round(boxes * torch.tensor([800., 600., 800., 600.],
                                                 device=dev))
    boxes = boxes.to(getattr(torch, dtype))
    valid = u(n, k) >= invalid
    cls = (u(n, k) * 20).floor() if classes else None
    return boxes, valid, cls


def nms_bound(torch, boxes, valid, cls, ks, ke, thresh, overlap):
    """The least time of one N1 launch on these inputs: the boxes, valid
    flags and classes read once and the (n, ks, ke) matrix written once
    over the memory rate, against the IoUs of the pairs that pass the
    order, validity and class tests (this data's count) over the f32
    peak; with that count and its share of the matrix."""
    n = valid.shape[0]
    with torch.no_grad():
        idx = torch.arange(ke, device=valid.device)
        cand = (idx[:ks, None] < idx[None, :]) & valid[:, :ks, None]
        if cls is not None:
            cand &= cls[:, :ks, None] == cls[:, None, :ke]
        pairs = int(cand.sum())
    del cand
    nbytes = n * ke * (4 * boxes.element_size() + 1
                       + (4 if cls is not None else 0)) + n * ks * ke
    t_bytes = nbytes / PEAK_BYTES_PER_S * 1e3
    t_ops = pairs * NMS_OPS_PER_PAIR / PEAK_FLOPS["float32"] * 1e3
    return dict(candidate_pairs=pairs,
                candidate_share=pairs / (n * ks * ke), bytes=nbytes,
                bound_ms=max(t_bytes, t_ops),
                bound_by="bytes" if t_bytes >= t_ops else "operations")


def phase_nms_kernel(torch, mt):
    """The NMS kernel against its plain version on the card, each case
    launched twice (equal), bit for bit; timed at each case's shape
    beside its bound (the output's bytes against the candidate pairs'
    operations at the f32 peak) and the plain version."""
    from mxnet_tpu_torch.ops import detection
    rows, fails = {}, []
    for name, (n, k, dtype, rule, thresh, classes, invalid) in \
            NMS_CASES.items():
        boxes, valid, cls = nms_case_inputs(torch, n, k, dtype, rule,
                                            classes, invalid, SEED + 70)
        overlap = detection.iou_matrix if rule == "corner" \
            else detection.pixel_iou
        thresh = detection._w(thresh, boxes)
        args = (boxes, valid, cls, k, k, thresh, overlap)
        launches = detection.suppress_matrix_cuda.launches
        got = detection.suppress_matrix_cuda(*args)
        again = detection.suppress_matrix_cuda(*args)
        want = detection.suppress_matrix_plain(*args)
        torch.cuda.synchronize()
        # the kernel's rows are padded to 16 bytes, False past column k
        mism = int((got[..., :k] != want).sum()) + int(got[..., k:].sum())
        equal = mism == 0 and torch.equal(got, again)
        row = dict(shape=[n, k], dtype=dtype, rule=rule, thresh=thresh,
                   classes=classes, launches=(
                       detection.suppress_matrix_cuda.launches - launches),
                   bit_identical=equal, mismatches=mism,
                   suppressing_pairs=int(want.sum()),
                   **nms_bound(torch, *args), library_ms=None)
        del got, again, want
        if name in NMS_TIMED:
            timed(row, "kernel_ms",
                  lambda: detection.suppress_matrix_cuda(*args), iters=3)
            timed(row, "plain_ms",
                  lambda: detection.suppress_matrix_plain(*args), iters=2,
                  repeats=3, warmup=1)
        rows[name] = row
        if not equal:
            fails.append(f"{name}: {mism} elements differ from the plain "
                         "version (or between two launches)")
        torch.cuda.empty_cache()
    emit("kernel_check_nms", cases=rows)
    if fails:
        raise RuntimeError("nms kernel: " + "; ".join(fails))
    return rows


# ---------------------------------------------------------------------------
# SSD-VGG16 (BASELINE config 5): training through Module, one fp32 step
# against the CPU, detection through Module.predict
# ---------------------------------------------------------------------------
def ssd_batches(torch, mt, device, batch, seed, n=2):
    """``n`` batches of train_ssd.py's synthetic images made on
    ``device``: noise in [0, 0.25), then 1-4 filled rectangles an image
    (sides 1/6 to 1/2 of the image), each in the intensity 0.3 + 0.7 c /
    (C - 1) of its class c; labels (batch, max_objects, 5) [class, x0,
    y0, x1, y1] in normalised corners, the first rows the objects', the
    rest -1."""
    C, S, G = SSD["num_classes"], SSD["size"], SSD["max_objects"]
    gen = torch.Generator(device=device).manual_seed(seed)

    def u(*shape):
        return torch.rand(shape, generator=gen, device=device)
    ar = torch.arange(S, device=device)
    out = []
    for _ in range(n):
        x = u(batch, 3, S, S) * 0.25
        present = torch.arange(4, device=device) < \
            (u(batch, 1) * 4).long() + 1                         # (B, 4)
        cls = (u(batch, 4) * C).long().clamp(max=C - 1)
        lo, hi = S // 6, S // 2
        w = (lo + u(batch, 4) * (hi - lo)).long()
        h = (lo + u(batch, 4) * (hi - lo)).long()
        x0 = (u(batch, 4) * (S - w)).long()
        y0 = (u(batch, 4) * (S - h)).long()
        for k in range(4):
            ins = ((ar[None, :, None] >= y0[:, k, None, None])
                   & (ar[None, :, None] < (y0 + h)[:, k, None, None])
                   & (ar[None, None, :] >= x0[:, k, None, None])
                   & (ar[None, None, :] < (x0 + w)[:, k, None, None])
                   & present[:, k, None, None])
            shade = 0.3 + 0.7 * cls[:, k].float() / (C - 1)
            x = torch.where(ins[:, None], shade[:, None, None, None], x)
        rows = torch.stack([cls.float(), x0 / S, y0 / S, (x0 + w) / S,
                            (y0 + h) / S], dim=-1)              # (B, 4, 5)
        label = torch.full((batch, G, 5), -1.0, device=device)
        label[:, :4] = torch.where(present[..., None], rows, -1.0)
        out.append(mt.io.DataBatch([mt.nd.NDArray(x.contiguous())],
                                   [mt.nd.NDArray(label)]))
    return out


def ssd_module(mt, ctx, compute_dtype=None, batch=None, arg_params=None):
    """train_ssd.py's Module over ssd_vgg16: data and label, Xavier
    with SSD_INIT (seeded) or ``arg_params``, SGD with momentum, wd and
    clipping."""
    B, S = batch or SSD["batch"], SSD["size"]
    mod = mt.mod.Module(mt.models.ssd_vgg16(num_classes=SSD["num_classes"]),
                        context=ctx, data_names=("data",),
                        label_names=("label",), compute_dtype=compute_dtype)
    mod.bind([mt.io.DataDesc("data", (B, 3, S, S))],
             [mt.io.DataDesc("label", (B, SSD["max_objects"], 5))])
    mt.random.seed(SEED)
    mod.init_params(mt.initializer.Xavier(**SSD_INIT),
                    arg_params=arg_params)
    mod.init_optimizer(optimizer="sgd", optimizer_params=dict(SSD_OPT))
    return mod


def conv_macs(mt, net, shapes):
    """Multiply-adds of every Convolution of ``net``'s forward at
    ``shapes``: each output element takes (C_in / groups) x kh x kw,
    counted while shape inference runs the ops on meta tensors."""
    from mxnet_tpu_torch.ops import registry
    op = registry.get("Convolution")
    fn, macs = op.fn, []

    def count(*args, **kw):
        out = fn(*args, **kw)
        macs.append(out.numel() * args[1][0].numel())
        return out
    op.fn = count
    try:
        net.infer_shape(**shapes)
    finally:
        op.fn = fn
    return sum(macs)


class OpCapture:
    """Within ``with OpCapture(mt, name) as cap:`` every call of the
    registered op ``name`` is kept as ((args, attrs), outputs) in
    ``cap.calls`` (tensors detached)."""

    def __init__(self, mt, name):
        from mxnet_tpu_torch.ops import registry
        self.op = registry.get(name)
        self.calls = []

    def __enter__(self):
        fn = self.fn = self.op.fn

        def keep(*args, **kw):
            out = fn(*args, **kw)
            det = [a.detach() if hasattr(a, "detach") else a for a in args]
            outs = out if isinstance(out, (tuple, list)) else (out,)
            self.calls.append(((det, dict(kw)),
                               [o.detach() for o in outs]))
            return out
        self.op.fn = keep
        return self

    def __exit__(self, *exc):
        self.op.fn = self.fn


def ssd_stats(torch, outs):
    """The step's losses and anchors from the three heads: the softmax
    cross-entropy over the labelled anchors (the valid normalisation of
    SoftmaxOutput), the smooth-L1 sum over the positive anchors, and the
    counts of positive, negative (mined) and ignored anchors; device
    tensors."""
    prob, loc, lab = (o._data for o in outs)
    lab = lab.long()
    valid = lab >= 0
    p = prob.gather(1, lab.clamp(min=0)[:, None])[:, 0]
    npos = (lab > 0).sum()
    cls = -(torch.log(p + 1e-12) * valid).sum() / valid.sum().clamp(min=1)
    return torch.stack([cls, loc.sum() / npos.clamp(min=1),
                        npos.float(), (lab == 0).sum().float(),
                        (~valid).sum().float()])


def ssd_steps(torch, mt, mod, batches, n, sync):
    """``n`` steps of forward(is_train=True) + update() over the batches
    in turn, each ended by ``sync``: the ms of each step on the host
    clock and its ssd_stats (read after the step's time)."""
    step_ms, stats = [], []
    for i in range(n):
        b = batches[i % len(batches)]
        t = time.monotonic()
        mod.forward(b, is_train=True)
        mod.update()
        sync()
        step_ms.append((time.monotonic() - t) * 1e3)
        stats.append(ssd_stats(torch, mod.get_outputs()))
    return step_ms, torch.stack(stats).cpu().numpy()


def ssd_split(torch, mt, mod, batch):
    """Where an SSD step's card time goes, part by part, each timed alone
    by CUDA events: the training forward, forward + backward, the
    optimizer after a synchronised backward, and, on the inputs the step
    hands them (captured), MultiBoxTarget, SoftmaxOutput's forward and
    gradient, and the loc head (smooth_l1 + MakeLoss) forward and
    backward.  The backbone and heads' share is forward + backward less
    those three."""
    from mxnet_tpu_torch.ops import registry
    with OpCapture(mt, "_contrib_MultiBoxTarget") as tgt, \
            OpCapture(mt, "SoftmaxOutput") as smo, \
            OpCapture(mt, "smooth_l1") as sl1, \
            OpCapture(mt, "MakeLoss") as mkl:
        mod.forward(batch, is_train=True)
    mod.backward()
    row = {}

    def fwd_bwd():
        mod.forward(batch, is_train=True)
        mod.backward()
    timed(row, "forward_ms", lambda: mod.forward(batch, is_train=True),
          iters=3, repeats=3, warmup=1)
    timed(row, "forward_backward_ms", fwd_bwd, iters=3, repeats=3, warmup=1)
    upd = []
    for _ in range(4):
        fwd_bwd()
        torch.cuda.synchronize()
        t = time.monotonic()
        mod.update()
        torch.cuda.synchronize()
        upd.append((time.monotonic() - t) * 1e3)
    row.update(update_ms=float(np.median(upd)), update_ms_min=min(upd),
               update_ms_max=max(upd))
    (args, kw), _ = tgt.calls[0]
    target = registry.get("_contrib_MultiBoxTarget").fn
    timed(row, "multibox_target_ms", lambda: target(*args, **kw), iters=5)
    (sargs, skw), _ = smo.calls[0]
    sm = registry.get("SoftmaxOutput").fn
    sdata = sargs[0].clone().requires_grad_()

    def softmax():
        out = sm(sdata, sargs[1], **skw)
        torch.autograd.grad(out, [sdata], torch.ones_like(out))
    timed(row, "softmax_output_ms", softmax, iters=5)
    (largs, lkw), _ = sl1.calls[0]
    (margs, mkw), _ = [c for c in mkl.calls
                       if c[0][1].get("normalization") == "valid"][0]
    l1, ml = registry.get("smooth_l1").fn, registry.get("MakeLoss").fn
    ldata = largs[0].clone().requires_grad_()

    def loc_head():
        out = ml(l1(ldata, **lkw), **mkw)
        torch.autograd.grad(out, [ldata], torch.ones_like(out))
    timed(row, "loc_loss_ms", loc_head, iters=5)
    row["backbone_heads_forward_backward_ms"] = row["forward_backward_ms"] \
        - row["multibox_target_ms"] - row["softmax_output_ms"] \
        - row["loc_loss_ms"]
    row["target_inputs"] = {"anchors": list(args[0].shape),
                            "label": list(args[1].shape),
                            "cls_pred": list(args[2].shape),
                            "dtype": str(args[2].dtype)}
    return row


def phase_ssd_train(torch, mt, peak_flops):
    """ssd_vgg16 at its published width through the port's Module:
    setup, SSD_WARMUP + SSD_STEPS steps over two batches made on the
    card with the counts reset just before and read just after,
    images/s, TFLOP/s on the analytic count, MFU, peak memory, the
    anchors and losses of each step; then one profiled step and the
    step's parts timed alone (ssd_split)."""
    dev = torch.device("cuda", 0)
    B, S = SSD["batch"], SSD["size"]
    t0 = time.monotonic()
    mod = ssd_module(mt, mt.gpu(0), "bfloat16")
    batches = ssd_batches(torch, mt, dev, B, SEED + 60)
    torch.cuda.synchronize()
    setup_s = time.monotonic() - t0
    n_params = sum(int(np.prod(a.shape))
                   for a in mod.get_params()[0].values())
    macs = conv_macs(mt, mt.models.ssd_vgg16(SSD["num_classes"]), dict(
        data=(1, 3, S, S), label=(1, SSD["max_objects"], 5)))

    torch.cuda.reset_peak_memory_stats()
    reset_counts(mt)
    n = SSD_WARMUP + SSD_STEPS
    step_ms, stats = ssd_steps(torch, mt, mod, batches, n,
                               torch.cuda.synchronize)
    counts = read_counts(mt)
    dispatch = mt.profiler.dispatch_counts()
    peak = torch.cuda.max_memory_allocated()
    if any(counts.values()) or dispatch.get("module.update") != n \
            or dispatch.get("module.backward") != n:
        raise RuntimeError(f"ssd_train: launches {counts} (want none: no "
                           f"hand-written kernel is on this path) / "
                           f"dispatches {dispatch}, want {n} updates and "
                           "backwards")
    losses = [float(c + l) for c, l in stats[:, :2]]
    first5, last5 = float(np.mean(losses[:5])), float(np.mean(losses[-5:]))
    if not np.isfinite(stats[:, :2]).all() or \
            not last5 < first5 - SSD_MARGIN:
        raise RuntimeError(f"ssd_train: losses {losses}: the last 5 "
                           f"({last5}) do not beat the first 5 ({first5}) "
                           f"by {SSD_MARGIN}")
    out = mod.get_outputs()
    shapes = [tuple(o.shape) for o in out]
    A = shapes[0][2]
    if shapes != [(B, SSD["num_classes"] + 1, A), (B, 4 * A), (B, A)] \
            or not all(bool(torch.isfinite(o._data).all()) for o in out):
        raise RuntimeError(f"ssd_train: outputs {shapes} not finite or of "
                           "the wrong shape")
    timed_ms = step_ms[SSD_WARMUP:]
    med = float(np.median(timed_ms))
    flops = 3 * 2.0 * macs * B
    tflops = flops / (med / 1e3) / 1e12

    torch.cuda.synchronize()
    with device_window(torch) as prof:
        t = time.monotonic()
        mod.forward(batches[0], is_train=True)
        mod.update()
        torch.cuda.synchronize()
        prof_ms = (time.monotonic() - t) * 1e3
    kernels = device_kernels(prof)
    busy = sum(k[0] for k in kernels)
    split = ssd_split(torch, mt, mod, batches[0])
    emit("ssd_train", model="ssd_vgg16 (mxnet_tpu/models/ssd.py)", **SSD,
         anchors=A, compute_dtype="bfloat16", masters="float32",
         optimizer=SSD_OPT, initializer="xavier gaussian magnitude 2",
         n_params=n_params,
         setup_s=setup_s, first_step_ms=step_ms[0],
         warmup_ms=step_ms[:SSD_WARMUP], steps=len(timed_ms),
         step_ms=timed_ms, median_step_ms=med, min_step_ms=min(timed_ms),
         max_step_ms=max(timed_ms), images_per_s=B / (med / 1e3),
         forward_macs_per_image=macs, flops_per_step=flops,
         flops_source="analytic: 3 x 2 x the convolutions' multiply-adds "
         "(conv_macs) x batch",
         achieved_tflops=tflops, mfu=tflops * 1e12 / peak_flops,
         mfu_peak_tflops=peak_flops / 1e12, peak_mem_bytes=peak,
         cls_loss=stats[:, 0].tolist(), loc_loss=stats[:, 1].tolist(),
         losses=losses, loss_first5_mean=first5, loss_last5_mean=last5,
         margin=SSD_MARGIN,
         positive_anchors=stats[:, 2].tolist(),
         negative_anchors=stats[:, 3].tolist(),
         ignored_anchors=stats[:, 4].tolist(),
         launches=counts, dispatches=dispatch)
    emit("ssd_profile", step_ms=prof_ms, device_busy_ms=busy,
         device_idle_share_of_step=max(0.0, 1 - busy / prof_ms),
         device_idle_share_of_median_step=max(0.0, 1 - busy / med),
         host_ms_of_median_step=max(0.0, med - busy), **split,
         top_kernels=[dict(ms=ms, count=c, name=k)
                      for ms, c, k in kernels[:15]])
    params = {k: v._data.clone() for k, v in mod.get_params()[0].items()}
    x = batches[0].data[0]
    del mod, batches, out
    torch.cuda.empty_cache()
    return counts, params, x


def ssd_numpy_params(mt, seed, batch):
    """Seeded weights of ssd_vgg16 (Xavier with SSD_INIT), as numpy,
    made on the CPU."""
    mod = mt.mod.Module(mt.models.ssd_vgg16(num_classes=SSD["num_classes"]),
                        context=mt.cpu(), data_names=("data",),
                        label_names=("label",))
    mod.bind([mt.io.DataDesc("data", (batch, 3, SSD["size"], SSD["size"]))],
             [mt.io.DataDesc("label", (batch, SSD["max_objects"], 5))])
    mt.random.seed(seed)
    mod.init_params(mt.initializer.Xavier(**SSD_INIT))
    return {n: a.asnumpy() for n, a in mod.get_params()[0].items()}


def ssd_fp32_step(torch, mt, ctx, params, x, y):
    """One fp32 Module step from ``params`` on (x, y): (cls + loc loss,
    {name: update}, MultiBoxTarget's inputs and outputs as numpy).  The
    update is read from the momentum SGD keeps, -lr (clip(gradient) + wd
    weight) after one step: new - old weight would add the rounding of
    the weight's last bit, a large part of a small update."""
    mod = ssd_module(mt, ctx, batch=x.shape[0], arg_params=params)
    batch = mt.io.DataBatch([mt.nd.array(x, ctx=mt.cpu())],
                            [mt.nd.array(y, ctx=mt.cpu())])
    with OpCapture(mt, "_contrib_MultiBoxTarget") as cap:
        mod.forward(batch, is_train=True)
    loss = float(ssd_stats(torch, mod.get_outputs())[:2].sum())
    mod.update()
    upd = {n: st[0].asnumpy() for n, st in mod._updater.states.items()}
    (args, kw), outs = cap.calls[0]
    return loss, upd, [a.cpu().numpy() for a in args], \
        [o.cpu().numpy() for o in outs], kw


def mining_cut_ties(card, cpu, kw):
    """Anchors whose class target differs between the card and the CPU,
    each with its background probability's distance from the mining cut
    (the largest background probability mined) on each side, relative
    to the cut.  ``card``/``cpu``: (MultiBoxTarget inputs, outputs)."""
    rows = []
    for n, a in zip(*np.nonzero(card[1][2] != cpu[1][2])):
        row = dict(image=int(n), anchor=int(a),
                   target=[float(card[1][2][n, a]), float(cpu[1][2][n, a])])
        for side, (ins, outs) in (("card", card), ("cpu", cpu)):
            logits = ins[2][n].astype(np.float64)
            p = np.exp(logits[0] - logits.max(0)) / \
                np.exp(logits - logits.max(0)).sum(0)
            cut = p[outs[2][n] == 0].max()
            row[side] = float(abs(p[a] - cut) / cut)
        rows.append(row)
    return rows


def float_ulps(a, b):
    """The largest distance of two f32 arrays in units in the last
    place."""
    ia = a.astype(np.float32).view(np.int32).astype(np.int64)
    ib = b.astype(np.float32).view(np.int32).astype(np.int64)
    ia = np.where(ia < 0, -(ia & 0x7FFFFFFF), ia)
    ib = np.where(ib < 0, -(ib & 0x7FFFFFFF), ib)
    return int(np.abs(ia - ib).max()) if ia.size else 0


def phase_ssd_fp32(torch, mt):
    """One fp32 step of ssd_vgg16 at full width, batch SSD_FP32_BATCH,
    card (TF32 off) against the CPU from the same weights and batch:
    MultiBoxTarget's outputs, the loss and every parameter's update."""
    params = ssd_numpy_params(mt, SEED + 61, SSD_FP32_BATCH)
    b = ssd_batches(torch, mt, torch.device("cpu"), SSD_FP32_BATCH,
                    SEED + 62, n=1)[0]
    x, y = b.data[0].asnumpy(), b.label[0].asnumpy()
    t0 = time.monotonic()
    gl, gu, gin, gout, kw = ssd_fp32_step(torch, mt, mt.gpu(0), params, x, y)
    gs = time.monotonic() - t0
    t0 = time.monotonic()
    cl, cu, cin, cout, _ = ssd_fp32_step(torch, mt, mt.cpu(), params, x, y)
    cs = time.monotonic() - t0
    ties = mining_cut_ties((gin, gout), (cin, cout), kw)
    bad_ties = [t for t in ties if sorted(t["target"]) != [-1.0, 0.0]
                or max(t["card"], t["cpu"]) > SSD_TIE_RTOL]
    mask_equal = bool(np.array_equal(gout[1], cout[1]))
    loc_ulps = float_ulps(gout[0], cout[0])
    inputs_equal = [bool(np.array_equal(gin[i], cin[i])) for i in (0, 1)]
    rel = update_rel_diffs(gu, cu)
    worst = max(rel, key=rel.get)
    emit("ssd_fp32_card_vs_cpu", batch=SSD_FP32_BATCH, loss_gpu=gl,
         loss_cpu=cl, loss_tol=SSD_FP32_LOSS_TOL,
         anchors_label_equal=inputs_equal, loc_mask_equal=mask_equal,
         loc_target_max_ulps=loc_ulps, loc_target_ulps_tol=SSD_LOC_ULPS,
         cls_target_differences=len(ties), mining_cut_ties=ties,
         tie_rtol=SSD_TIE_RTOL, positives=int((cout[2] > 0).sum()),
         negatives=int((cout[2] == 0).sum()),
         update_rel_diff_worst=rel[worst], worst_param=worst,
         update_rtol=SSD_FP32_UPDATE_RTOL, gpu_s=gs, cpu_s=cs)
    if not all(inputs_equal) or not mask_equal or loc_ulps > SSD_LOC_ULPS \
            or bad_ties or not np.isfinite(gl) \
            or abs(gl - cl) > SSD_FP32_LOSS_TOL \
            or rel[worst] > SSD_FP32_UPDATE_RTOL \
            or not all(np.isfinite(v).all() for v in gu.values()):
        raise RuntimeError(
            f"ssd fp32: anchors/label equal {inputs_equal}, loc mask equal "
            f"{mask_equal}, loc targets {loc_ulps} ulps apart, target "
            f"differences not near ties at the mining cut {bad_ties}; loss "
            f"{gl} card, {cl} CPU (tol {SSD_FP32_LOSS_TOL}); worst update "
            f"{worst} {rel[worst]} (tol {SSD_FP32_UPDATE_RTOL})")
    torch.cuda.empty_cache()


def np_greedy_nms(boxes, classes, valid, thresh):
    """Plain greedy NMS of one image's boxes, sorted by score: visit j in
    turn; a kept j drops every later box of its class whose IoU with it
    (corners, no +1, f32 in the op's order) is above ``thresh``."""
    f = np.float32
    keep = valid.copy()
    area = (boxes[:, 2] - boxes[:, 0]) * (boxes[:, 3] - boxes[:, 1])
    for j in range(len(boxes)):
        if not keep[j]:
            continue
        iw = np.maximum(f(0), np.minimum(boxes[j, 2], boxes[j + 1:, 2])
                        - np.maximum(boxes[j, 0], boxes[j + 1:, 0]))
        ih = np.maximum(f(0), np.minimum(boxes[j, 3], boxes[j + 1:, 3])
                        - np.maximum(boxes[j, 1], boxes[j + 1:, 1]))
        inter = iw * ih
        union = area[j] + area[j + 1:] - inter
        with np.errstate(divide="ignore", invalid="ignore"):
            iou = np.where(union > 0, inter / union, f(0))
        keep[j + 1:] &= ~((iou > f(thresh)) & (classes[j + 1:] == classes[j]))
    return keep


def detect_vs_numpy(out, cls_prob, kw):
    """Count of an image's rows where MultiBoxDetection's output ``out``
    (A, 6) disagrees with a numpy greedy NMS over the same sorted boxes
    (the classes and validity recomputed from ``cls_prob`` (C, A) and the
    sort checked against the output's scores)."""
    fg = cls_prob[1:]
    score, cid = fg.max(0), fg.argmax(0)
    valid = score >= np.float32(kw.get("threshold", 0.01))
    order = np.argsort(-np.where(valid, score, -np.inf), kind="stable")
    if not np.array_equal(out[:, 1], score[order]):
        return -1
    keep = np_greedy_nms(out[:, 2:], cid[order], valid[order],
                         kw.get("nms_threshold", 0.5))
    want = np.where(keep, cid[order].astype(np.float32), -1.0)
    return int((want != out[:, 0]).sum())


def nms_path_kernel(torch, args):
    """N1 on ``args`` (``suppress_matrix``'s) against its plain version,
    bit for bit, and a relaunch; timed beside the plain version and its
    bound on this data (the pairs that pass the order, validity and class
    tests, an IoU each)."""
    from mxnet_tpu_torch.ops import detection
    ke = args[4]
    got = detection.suppress_matrix_cuda(*args)
    again = detection.suppress_matrix_cuda(*args)
    want = detection.suppress_matrix_plain(*args)
    kern = dict(shape=list(want.shape),
                dtype=str(args[0].dtype).replace("torch.", ""),
                mismatches=int((got[..., :ke] != want).sum())
                + int(got[..., ke:].sum()),
                relaunch_equal=bool(torch.equal(got, again)),
                **nms_bound(torch, *args))
    del got, again, want
    timed(kern, "kernel_ms", lambda: detection.suppress_matrix_cuda(*args),
          iters=3)
    timed(kern, "plain_ms", lambda: detection.suppress_matrix_plain(*args),
          iters=2, repeats=3, warmup=1)
    return kern


def phase_ssd_detect(torch, mt, params, x):
    """The mode="detect" graph through Module (bf16 compute) with
    ssd_train's parameters at batch 32: ms a batch (forward on card
    data) and images/s, Module.predict over an NDArrayIter, and
    MultiBoxDetection's and its NMS's own ms on the inputs the graph
    hands it, split into the suppression matrices, the nonzero over them
    and the rounds.  Checks: predict equals the op on those inputs; on two
    images (the inputs made f32) the card's op equals the CPU's, and both
    a numpy greedy NMS."""
    from mxnet_tpu_torch.ops import detection, registry
    B, S = SSD["batch"], SSD["size"]
    net = mt.models.ssd_vgg16(num_classes=SSD["num_classes"], mode="detect")
    mod = mt.mod.Module(net, context=mt.gpu(0), data_names=("data",),
                        label_names=None, compute_dtype="bfloat16")
    mod.bind([mt.io.DataDesc("data", (B, 3, S, S))], for_training=False)
    mod.init_params(arg_params={n: mt.nd.NDArray(v) for n, v in
                                params.items() if n in net.list_arguments()})
    batch = mt.io.DataBatch([x], [])
    reset_counts(mt)
    with OpCapture(mt, "_contrib_MultiBoxDetection") as cap:
        pred = mod.predict(mt.io.NDArrayIter(x.asnumpy(), batch_size=B))
    counts = read_counts(mt)
    (args, kw), (want,) = cap.calls[0]
    det = registry.get("_contrib_MultiBoxDetection").fn
    pred_equal = bool(torch.equal(pred._data, det(*args, **kw).cpu()))
    row = dict(batch=B, predict_equals_op=pred_equal, launches=counts,
               op_input_dtypes=[str(a.dtype) for a in args])

    def forward():
        mod.forward(batch, is_train=False)
        return mod.get_outputs()[0]
    timed(row, "batch_ms", forward, iters=3, repeats=5, warmup=1)
    row["images_per_s"] = B / (row["batch_ms"] / 1e3)
    timed(row, "multibox_detection_ms", lambda: det(*args, **kw), iters=3,
          repeats=5, warmup=1)
    # the NMS alone, on the sorted boxes the op hands it (captured)
    nms_calls, nms_keep = [], detection.nms_keep

    def keep_args(*a, **k):
        nms_calls.append((a, k))
        return nms_keep(*a, **k)
    detection.nms_keep = keep_args
    try:
        out = det(*args, **kw)
    finally:
        detection.nms_keep = nms_keep
    (nargs, nkw), stats = nms_calls[0], {}

    def nms():
        return nms_keep(*nargs, **dict(nkw, stats=stats))
    keep = nms()
    timed(row, "nms_ms", nms, iters=3, repeats=5, warmup=1)
    # its parts: the suppression matrices (N1's launches), the nonzero
    # that lists their pairs, and the rounds over those pairs
    nb, nv, nth, nov = nargs
    k_eff = int(nv.any(dim=0).nonzero()[-1]) + 1
    k_sup = k_eff if nkw.get("topk") is None else min(int(nkw["topk"]),
                                                      k_eff)

    def matrices():
        return detection.nms_matrices(nb, nv, nth, nov, nkw.get("classes"),
                                      k_sup, k_eff)

    def suppress():
        for _ in matrices():
            pass
    timed(row, "nms_suppress_ms", suppress, iters=3, repeats=5, warmup=1)
    built = list(matrices())
    timed(row, "nms_nonzero_ms", lambda: [S.nonzero() for _, S in built],
          iters=3, repeats=5, warmup=1)
    src, dst = detection.nms_pairs(built, k_eff)
    del built
    timed(row, "nms_rounds_ms",
          lambda: detection.nms_rounds(nv[:, :k_eff], src, dst), iters=3,
          repeats=5, warmup=1)
    per = max(1, detection.NMS_CHUNK_ELEMENTS // (k_sup * k_eff))
    row["nms_matrices"] = len(range(0, nv.shape[0], per))
    del src, dst
    # one N1 launch on the path's own first chunk
    ncls = nkw.get("classes")
    kern = nms_path_kernel(torch, (
        nb[:per], nv[:per], None if ncls is None else ncls[:per], k_sup,
        k_eff, nth, nov))
    row["nms_kernel"] = kern
    row.update(nms_rounds=stats["rounds"], nms_pairs=stats["pairs"],
               valid_boxes=int(nargs[1].sum()), kept_boxes=int(keep.sum()),
               nms_equals_op=bool(torch.equal(
                   torch.where(keep, nkw["classes"], -1.0), out[..., 0])))
    # two images, the inputs made f32: card against CPU against numpy
    k = SSD_DETECT_IMAGES
    f32 = [a[:k].float() if a.shape[0] == B else a.float() for a in args]
    gpu_out = det(*f32, **kw).cpu().numpy()
    cpu_out = det(*[a.cpu() for a in f32], **kw).numpy()
    probs = f32[0].cpu().numpy()
    ids_equal = bool(np.array_equal(gpu_out[..., 0], cpu_out[..., 0]))
    value_diff = float(np.abs(gpu_out - cpu_out).max())
    numpy_diff = [[detect_vs_numpy(o[i], probs[i], kw) for i in range(k)]
                  for o in (gpu_out, cpu_out)]
    row.update(card_vs_cpu_ids_equal=ids_equal,
               card_vs_cpu_max_abs_diff=value_diff,
               rows_differing_from_numpy_nms=dict(zip(("card", "cpu"),
                                                      numpy_diff)),
               detections_per_image=[int((gpu_out[i, :, 0] >= 0).sum())
                                     for i in range(k)])
    emit("ssd_detect", **row)
    flash = {k: v for k, v in counts.items() if k != "nms_suppress"}
    if not pred_equal or any(flash.values()) or not counts["nms_suppress"] \
            or not row["nms_equals_op"] or kern["mismatches"] \
            or not kern["relaunch_equal"] \
            or not ids_equal or value_diff > SSD_DETECT_TOL \
            or any(d != 0 for ds in numpy_diff for d in ds) \
            or tuple(pred.shape) != (B, want.shape[1], 6):
        raise RuntimeError(f"ssd_detect: {row}")
    del mod
    torch.cuda.empty_cache()
    return counts, kern


# --------------------------------------------------------------------------
# The rest of the Gluon model zoo trained through gluon.data, the four
# Module examples' loss heads, and the dense ops ported with them
# --------------------------------------------------------------------------
# six zoo networks at their published widths (mxnet_tpu/gluon/model_zoo/
# vision/: VGG-16 (Simonyan & Zisserman 2015, config D), AlexNet
# (Krizhevsky et al. 2012, one tower), SqueezeNet 1.1, DenseNet-121
# (Huang et al. 2017), MobileNet 1.0 (Howard et al. 2017), Inception v3
# (Szegedy et al. 2016)), 1000 classes, their published inputs, each fed
# by gluon.data.DataLoader(ArrayDataset(images, labels), batch 64,
# shuffle, 4 worker threads, last_batch="discard") and trained through
# gluon.Trainer, hybridized with bf16 compute over fp32 masters,
# ZOO_WARMUP + ZOO_STEPS steps (one epoch of the ZOO_IMAGES images).
ZOO_NETS = (("vgg16", 224), ("alexnet", 224), ("squeezenet1.1", 224),
            ("densenet121", 224), ("mobilenet1.0", 224),
            ("inceptionv3", 299))
ZOO_BATCH = 64
ZOO_WARMUP = 3
ZOO_STEPS = 10
ZOO_WORKERS = 4
ZOO_IMAGES = (ZOO_WARMUP + ZOO_STEPS) * ZOO_BATCH
# SGD lr 0.005, momentum 0.9, wd 1e-4: in the CPU rehearsal at lr 0.01
# (VGG's and AlexNet's published rate, for a batch of 128-256) VGG-16's
# loss spiked to 10.9 and SqueezeNet 1.1's to 9.9 within 13 steps of
# batch 16; at 0.005 every network's loss fell
ZOO_OPT = {"learning_rate": 0.005, "momentum": 0.9, "wd": 1e-4}
# the learnable rule: each image is one of ZOO_CLASSES seeded 8x8 colour
# templates, upsampled, plus as much unit noise; its label is the
# template's class (of the 1000 outputs)
ZOO_CLASSES = 16
# the mean loss of the last 3 steps must beat the first 3's by this many
# nats, fixed from the CPU rehearsal before the first card run
# (tests/torch_numerics.py zoo_data: the same loop in fp32 at batch 16,
# VGG, AlexNet, SqueezeNet and MobileNet at 112x112, DenseNet at 224x224
# and Inception at 299x299): the drops were 2.12 (VGG-16), 3.70
# (AlexNet), 0.41 (SqueezeNet 1.1), 2.46 (DenseNet-121), 1.85 (MobileNet)
# and 4.15 nats (Inception v3); the margin is a fifth of the smallest, as
# RESNET_MARGIN's
ZOO_MARGIN = 0.08
# one fp32 SGD step of each network at batch 2 of its input, the card
# (TF32 off) against the CPU from the same seeded weights, with
# gluon_fp32_card_vs_cpu's budget; Dropout off (each device draws its
# own masks) and, for DenseNet, BatchNorm on the moving statistics (the
# DEEP_BN rule of tests/torch_numerics.py deep_bn: its batch-statistics
# backward through 58 BatchNorms is ill-conditioned in fp32)
ZOO_FP32_BATCH = 2
ZOO_FP32_DEEP_BN = ("densenet121",)


def zoo_images(side, seed):
    """ZOO_IMAGES synthetic images of side x side in host memory and
    their int32 labels (the learnable rule above)."""
    rng = np.random.default_rng(seed)
    tiles = rng.uniform(-1, 1, (ZOO_CLASSES, 3, 8, 8)).astype(np.float32)
    rep = -(-side // 8)
    tiles = tiles.repeat(rep, 2).repeat(rep, 3)[:, :, :side, :side]
    labels = rng.integers(0, ZOO_CLASSES, ZOO_IMAGES).astype(np.int32)
    images = rng.standard_normal((ZOO_IMAGES, 3, side, side),
                                 dtype=np.float32)
    images += tiles[labels]
    return images, labels


def zoo_net(mt, name, ctx, seed, classes=1000):
    with mt.name.NameManager():
        net = mt.gluon.model_zoo.vision.get_model(name, classes=classes)
    mt.random.seed(seed)
    net.initialize(mt.initializer.Xavier(rnd_type="gaussian",
                                         magnitude=2.0), ctx=ctx)
    return net


def zoo_loader(mt, images, labels, batch, workers, seed):
    np.random.seed(seed)              # the RandomSampler's shuffle
    return mt.gluon.data.DataLoader(
        mt.gluon.data.ArrayDataset(images, labels), batch_size=batch,
        shuffle=True, num_workers=workers, last_batch="discard")


def zoo_train_loop(mt, net, trainer, loss_fn, loader, n, sync):
    """``n`` steps over the loader: the ms the main thread waits for each
    batch, the ms of each step (record -> loss -> backward -> step,
    ended by ``sync``), and each step's mean loss (read after the last
    step); the last batch too."""
    wait_ms, step_ms, losses = [], [], []
    it = iter(loader)
    for _ in range(n):
        t = time.monotonic()
        x, y = next(it)
        t1 = time.monotonic()
        with mt.autograd.record():
            loss = loss_fn(net(x), y)
        loss.backward()
        trainer.step(x.shape[0])
        sync()
        wait_ms.append((t1 - t) * 1e3)
        step_ms.append((time.monotonic() - t1) * 1e3)
        losses.append(loss.mean())
    return wait_ms, step_ms, [float(l.asscalar()) for l in losses], (x, y)


def forward_flops(torch, fn):
    """Multiply-add FLOPs (2 a product) of the convolutions and matrix
    products ``fn`` runs, counted from their shapes as they dispatch."""
    from torch.utils._python_dispatch import TorchDispatchMode
    aten = torch.ops.aten
    total = [0]

    class Count(TorchDispatchMode):
        def __torch_dispatch__(self, func, types, args=(), kwargs=None):
            out = func(*args, **(kwargs or {}))
            if func is aten.convolution.default:
                w = args[1]
                total[0] += 2 * out.numel() * int(np.prod(w.shape[1:]))
            elif func in (aten.mm.default, aten.addmm.default):
                a, b = args[-2], args[-1]
                total[0] += 2 * a.shape[0] * a.shape[1] * b.shape[1]
            elif func is aten.bmm.default:
                a, b = args
                total[0] += 2 * a.shape[0] * a.shape[1] * a.shape[2] * \
                    b.shape[2]
            return out
    with Count():
        fn()
    return total[0]


def phase_gluon_zoo_train(torch, mt, peak_flops):
    """The slice's main path: each network of ZOO_NETS at full width fed
    by the DataLoader and trained through gluon.Trainer on cuda:0, the
    launch and dispatch counts reset just before its steps and read just
    after; then its analytic FLOPs and one profiled step."""
    rows, fails, data = {}, [], {}
    n = ZOO_WARMUP + ZOO_STEPS
    data_s = 0.0
    for name, side in ZOO_NETS:
        if side not in data:
            data.clear()
            t0 = time.monotonic()
            data[side] = zoo_images(side, SEED + 40)
            data_s += time.monotonic() - t0
        images, labels = data[side]
        t0 = time.monotonic()
        net = zoo_net(mt, name, mt.gpu(0), SEED)
        net.hybridize(compute_dtype="bfloat16")
        trainer = mt.gluon.Trainer(net.collect_params(), "sgd",
                                   dict(ZOO_OPT))
        loss_fn = mt.gluon.loss.SoftmaxCrossEntropyLoss()
        loader = zoo_loader(mt, images, labels, ZOO_BATCH, ZOO_WORKERS,
                            SEED + 41)
        setup_s = time.monotonic() - t0
        torch.cuda.synchronize()
        torch.cuda.reset_peak_memory_stats()
        # the path: counts start at 0 here and are read after
        reset_counts(mt)
        wait_ms, step_ms, losses, (x, y) = zoo_train_loop(
            mt, net, trainer, loss_fn, loader, n, torch.cuda.synchronize)
        counts = read_counts(mt)
        dispatch = mt.profiler.dispatch_counts()
        peak = torch.cuda.max_memory_allocated()
        timed_ms = step_ms[ZOO_WARMUP:]
        med = float(np.median(timed_ms))
        fwd = forward_flops(torch, lambda: net(x))
        flops = 3 * fwd
        tflops = flops / (med / 1e3) / 1e12
        torch.cuda.synchronize()
        with device_window(torch) as prof:
            t = time.monotonic()
            with mt.autograd.record():
                loss = loss_fn(net(x), y)
            loss.backward()
            trainer.step(x.shape[0])
            torch.cuda.synchronize()
            prof_ms = (time.monotonic() - t) * 1e3
        kernels = device_kernels(prof)
        busy = sum(k[0] for k in kernels)
        first3, last3 = float(np.mean(losses[:3])), float(np.mean(losses[-3:]))
        params = net.collect_params()
        row = dict(
            image=[3, side, side], setup_s=setup_s,
            first_step_ms=step_ms[0], warmup_ms=step_ms[:ZOO_WARMUP],
            steps=len(timed_ms), step_ms=timed_ms, median_step_ms=med,
            min_step_ms=min(timed_ms), max_step_ms=max(timed_ms),
            images_per_s=ZOO_BATCH / (med / 1e3),
            loader_wait_ms=wait_ms, median_loader_wait_ms=float(
                np.median(wait_ms[ZOO_WARMUP:])),
            max_loader_wait_ms=max(wait_ms[ZOO_WARMUP:]),
            epoch_images_per_s=ZOO_BATCH * len(timed_ms) / (
                sum(timed_ms) + sum(wait_ms[ZOO_WARMUP:])) * 1e3,
            forward_flops_per_image=fwd / ZOO_BATCH, flops_per_step=flops,
            flops_source="analytic: 2 x the multiply-adds of every "
            "convolution and matrix product of one forward, counted from "
            "their shapes as they dispatch, x 3 (forward and backward)",
            achieved_tflops=tflops, mfu=tflops * 1e12 / peak_flops,
            peak_mem_bytes=peak, profiled_step_ms=prof_ms,
            device_busy_ms=busy,
            device_idle_share_of_step=max(0.0, 1 - busy / prof_ms),
            device_idle_share_of_median_step=max(0.0, 1 - busy / med),
            top_kernels=[dict(ms=ms, count=c, name=k)
                         for ms, c, k in kernels[:5]],
            n_params=sum(int(np.prod(p.shape)) for k, p in params.items()
                         if "running" not in k),
            dispatches=dispatch, kernel_launches=counts, losses=losses,
            loss_first3_mean=first3, loss_last3_mean=last3)
        rows[name] = row
        want = {"trainer.step": n, "autograd.backward": n,
                "gluon.cached_forward": n}
        if any(dispatch.get(k) != v for k, v in want.items()) \
                or any(counts.values()):
            fails.append(f"{name}: dispatches {dispatch} (want {want}) "
                         f"and kernel launches {counts} (want none)")
        if not all(np.isfinite(losses)):
            fails.append(f"{name}: non-finite loss in {losses}")
        if not last3 < first3 - ZOO_MARGIN:
            fails.append(f"{name}: mean of the last 3 losses {last3} does "
                         f"not beat the first 3's {first3} by {ZOO_MARGIN}")
        if busy <= 0:
            fails.append(f"{name}: the profile shows no device time")
        del net, trainer, loader, x, y
        torch.cuda.empty_cache()
    data.clear()
    emit("gluon_zoo_train", batch=ZOO_BATCH, classes=1000,
         hybridized=True, compute_dtype="bfloat16", masters="float32",
         optimizer="gluon.Trainer sgd lr 0.01 momentum 0.9 wd 1e-4",
         initializer="xavier gaussian magnitude 2",
         data=f"{ZOO_IMAGES} synthetic images in host memory, {ZOO_CLASSES}"
         " classes (a seeded template each plus unit noise), "
         "gluon.data.DataLoader(ArrayDataset, shuffle, num_workers="
         f"{ZOO_WORKERS}, last_batch='discard')", data_s=data_s,
         margin=ZOO_MARGIN, cudnn_benchmark=torch.backends.cudnn.benchmark,
         failures=fails, **rows)
    if fails:
        raise RuntimeError("gluon_zoo_train: " + "; ".join(fails))


def zoo_numpy_params(mt, name, side, seed):
    """Seeded weights of a zoo network by name (He-scaled weights, gamma
    near 1, small beta, running statistics near (0, 1)) as numpy, the
    shapes from a CPU net's deferred initialization."""
    net = zoo_net(mt, name, mt.cpu(), seed)
    net(mt.nd.zeros((1, 3, side, side), ctx=mt.cpu()))
    rng = np.random.default_rng(seed)
    out = {}
    for k, p in net.collect_params().items():
        shape = p.shape
        if k.endswith("running_var"):
            v = rng.uniform(0.5, 1.5, shape)
        else:
            v = rng.standard_normal(shape)
            if k.endswith("_weight"):
                v *= np.sqrt(2.0 / np.prod(shape[1:]))
            elif k.endswith("_gamma"):
                v = 1 + 0.1 * v
            else:
                v *= 0.1
        out[k] = v.astype(np.float32)
    return out


def zoo_fp32_step(mt, ctx, name, values, x, y, dtype="float32"):
    """One SGD-momentum step of zoo network ``name`` from ``values`` on
    ``ctx``, hybridized, Dropout off (and DenseNet's BatchNorm on its
    moving statistics): (loss, gradients, new parameters, seconds,
    output-layer parameter names)."""
    net = zoo_net(mt, name, ctx, SEED)
    for b in _blocks(net):
        if type(b).__name__ == "Dropout":
            b._rate = 0.0
        if type(b).__name__ == "BatchNorm" and name in ZOO_FP32_DEEP_BN:
            b._kwargs["use_global_stats"] = True
    net.cast(dtype)
    mt.convert.gluon_params_from_numpy(net.collect_params(), values, ctx)
    net.hybridize()
    trainer = mt.gluon.Trainer(net.collect_params(), "sgd", dict(ZOO_OPT))
    loss_fn = mt.gluon.loss.SoftmaxCrossEntropyLoss()
    xs = mt.nd.array(x, ctx=ctx, dtype=dtype)
    ys = mt.nd.array(y, ctx=ctx, dtype="int32")
    t0 = time.monotonic()
    with mt.autograd.record():
        loss = loss_fn(net(xs), ys)
    loss.backward()
    grads = {k: p.grad().asnumpy() for k, p in net.collect_params().items()
             if p.grad_req != "null"}
    trainer.step(x.shape[0])
    lval = float(loss.mean().asscalar())
    secs = time.monotonic() - t0
    head = [k for k in net.output.collect_params() if k in grads]
    return lval, grads, mt.convert.gluon_params_to_numpy(
        net.collect_params()), secs, head


def _blocks(net):
    yield net
    for c in net._children:
        yield from _blocks(c)


def zoo_fp32_compare(card, cpu, values):
    """gluon_fp32_compare's numbers, the output layer as the head."""
    (gl, gg, gp, gs, head), (cl, cg, cp, cs, _) = card, cpu

    def rel(a, b):
        return float(np.abs(a - b).max() / max(np.abs(b).max(), 1e-30))

    def norm_rel(pairs):
        return float(np.sqrt(sum(((a - b) ** 2).sum() for a, b in pairs))
                     / np.sqrt(sum((b ** 2).sum() for _, b in pairs)))
    upd = {k: (gp[k] - values[k], cp[k] - values[k]) for k in cg}
    aux = {k: rel(gp[k], cp[k]) for k in cp if "running" in k}
    row = dict(loss_gpu=gl, loss_cpu=cl, loss_diff=abs(gl - cl),
               head=head,
               head_grad_rel_diff=max(rel(gg[k], cg[k]) for k in head),
               head_update_rel_diff=max(rel(*upd[k]) for k in head),
               grad_norm_rel_diff=norm_rel([(gg[k], cg[k]) for k in cg]),
               update_norm_rel_diff=norm_rel(list(upd.values())),
               gpu_s=gs, cpu_s=cs,
               finite=bool(all(np.isfinite(v).all() for v in gp.values())))
    if aux:
        worst = max(aux, key=aux.get)
        row.update(worst_aux_rel_diff=aux[worst], worst_aux=worst)
    return row


def phase_gluon_zoo_fp32(torch, mt):
    """One fp32 step of each ZOO_NETS network at full width (batch 2 of
    its input), the card (TF32 off) against the CPU from the same
    weights."""
    fails, rows = [], {}
    for i, (name, side) in enumerate(ZOO_NETS):
        values = zoo_numpy_params(mt, name, side, SEED + 50 + i)
        rng = np.random.default_rng(SEED + 60 + i)
        x = rng.uniform(-1, 1, (ZOO_FP32_BATCH, 3, side, side)) \
            .astype(np.float32)
        y = rng.integers(0, 1000, ZOO_FP32_BATCH).astype(np.int32)
        row = zoo_fp32_compare(
            zoo_fp32_step(mt, mt.gpu(0), name, values, x, y),
            zoo_fp32_step(mt, mt.cpu(), name, values, x, y), values)
        row["batch_norm"] = ("moving statistics (DEEP_BN)"
                             if name in ZOO_FP32_DEEP_BN else "batch")
        rows[name] = row
        for key, lim in (("loss_diff", GLUON_FP32_LOSS_TOL),
                         ("worst_aux_rel_diff", GLUON_FP32_AUX_RTOL),
                         ("head_grad_rel_diff", GLUON_FP32_HEAD_RTOL),
                         ("head_update_rel_diff", GLUON_FP32_HEAD_RTOL),
                         ("grad_norm_rel_diff", GLUON_FP32_NORM_RTOL),
                         ("update_norm_rel_diff", GLUON_FP32_NORM_RTOL)):
            if key in row and not row[key] <= lim:
                fails.append(f"{name} {key} {row[key]} beyond {lim}")
        if not row["finite"]:
            fails.append(f"{name}: non-finite parameters on the card")
        torch.cuda.empty_cache()
    emit("gluon_zoo_fp32_card_vs_cpu", batch=ZOO_FP32_BATCH,
         dropout="off (each device draws its own masks)",
         budget=dict(loss=GLUON_FP32_LOSS_TOL, aux=GLUON_FP32_AUX_RTOL,
                     head=GLUON_FP32_HEAD_RTOL, norm=GLUON_FP32_NORM_RTOL),
         failures=fails, **rows)
    if fails:
        raise RuntimeError("gluon_zoo_fp32_card_vs_cpu: " + "; ".join(fails))


# The four Module examples' graphs, rebuilt here (the examples are files
# of the JAX package's tree) at each example's own sizes, on synthetic
# data in place of sklearn's digits (64 pixels in [0, 1], 1797 samples)
# and MovieLens: examples/autoencoder/stacked_ae.py (64-32-16, mirrored,
# LinearRegressionOutput, Adam 1e-3, batch 100), examples/recommender/
# matrix_fact.py (200 users, 100 items, 8 hidden, 8000 ratings from rank-4
# factors, Embedding -> product -> sum -> LinearRegressionOutput, Adam
# 0.02, Normal(0.3), batch 256), examples/gan/dcgan_digits.py (the
# Deconvolution -> BatchNorm -> relu generator and the Convolution ->
# BatchNorm -> LeakyReLU discriminator at ngf = ndf = 16, z 32, 32x32,
# LogisticRegressionOutput, Adam 2e-4 beta1 0.5, batch 64, the generator
# trained on the discriminator's input gradient), examples/svm/
# svm_digits.py (64-128-10 MLP, SVMOutput, SGD 0.1 momentum 0.9 wd 1e-4,
# batch 100).  Each trains HEADS_EPOCHS epochs in fp32 through Module on
# NDArrayIter batches; its metric (reconstruction MSE, validation RMSE,
# the discriminator's loss, test accuracy) must improve by HEADS_MARGIN,
# fixed from the CPU rehearsal (tests/torch_numerics.py zoo_data: gains
# of 0.377 in MSE, 0.416 in RMSE, 0.485 nats and 0.889 in accuracy), a
# fifth of each; one fp32 step on the card must equal the CPU's within
# HEADS_STEP_RTOL of each parameter's largest value (one CPU thread
# against eight, two reduction orders: 0 for three examples, 5.9e-6 for
# the DCGAN's BatchNorms; the card's products sum in a third order)
HEADS_EPOCHS = {"stacked_ae": 8, "matrix_fact": 10, "dcgan": 3, "svm": 12}
HEADS_MARGIN = {"stacked_ae": 0.075, "matrix_fact": 0.083, "dcgan": 0.097,
                "svm": 0.178}
HEADS_STEP_RTOL = 1e-4


def digits_like(seed, n=1797):
    """Stand-ins for sklearn's digits: 10 seeded 8x8 templates in [0, 1]
    plus noise, flattened to 64 values in [0, 1], with their labels."""
    rng = np.random.default_rng(seed)
    tiles = rng.uniform(0, 1, (10, 64))
    y = rng.integers(0, 10, n)
    x = np.clip(tiles[y] + 0.25 * rng.standard_normal((n, 64)), 0, 1)
    return x.astype(np.float32), y.astype(np.float32)


def ae_sym(mt, dims=(64, 32, 16)):
    """stacked_ae.py full_sym."""
    h = mt.sym.Variable("data")
    label = mt.sym.Variable("recon_label")
    for i, d in enumerate(dims[1:]):
        h = mt.sym.Activation(mt.sym.FullyConnected(
            h, num_hidden=d, name="enc%d" % i), act_type="relu")
    for i in reversed(range(len(dims) - 1)):
        h = mt.sym.FullyConnected(h, num_hidden=dims[i], name="dec%d" % i)
        if i > 0:
            h = mt.sym.Activation(h, act_type="relu")
    return mt.sym.LinearRegressionOutput(h, label, name="recon")


def mf_sym(mt, users=200, items=100, hidden=8):
    """matrix_fact.py plain_net."""
    user = mt.sym.Embedding(mt.sym.Variable("user"), input_dim=users,
                            output_dim=hidden, name="user_embed")
    item = mt.sym.Embedding(mt.sym.Variable("item"), input_dim=items,
                            output_dim=hidden, name="item_embed")
    pred = mt.sym.Flatten(mt.sym.sum(user * item, axis=1))
    return mt.sym.LinearRegressionOutput(data=pred,
                                         label=mt.sym.Variable("score"),
                                         name="lro")


def dcgan_syms(mt, ngf=16, ndf=16, nc=1):
    """dcgan_digits.py make_generator and make_discriminator."""
    eps = 1e-5 + 1e-12
    g = mt.sym.Variable("rand")
    for i, (nf, k, s, p) in enumerate(((ngf * 4, 4, 1, 0),
                                       (ngf * 2, 4, 2, 1),
                                       (ngf, 4, 2, 1))):
        g = mt.sym.Deconvolution(g, name=f"g{i + 1}", kernel=(k, k),
                                 stride=(s, s), pad=(p, p), num_filter=nf,
                                 no_bias=True)
        g = mt.sym.BatchNorm(g, name=f"gbn{i + 1}", fix_gamma=True, eps=eps)
        g = mt.sym.Activation(g, name=f"gact{i + 1}", act_type="relu")
    g = mt.sym.Deconvolution(g, name="g4", kernel=(4, 4), stride=(2, 2),
                             pad=(1, 1), num_filter=nc, no_bias=True)
    g = mt.sym.Activation(g, name="gact4", act_type="tanh")
    d = mt.sym.Variable("data")
    d = mt.sym.Convolution(d, name="d1", kernel=(4, 4), stride=(2, 2),
                           pad=(1, 1), num_filter=ndf, no_bias=True)
    d = mt.sym.LeakyReLU(d, name="dact1", act_type="leaky", slope=0.2)
    for i, nf in ((2, ndf * 2), (3, ndf * 4)):
        d = mt.sym.Convolution(d, name=f"d{i}", kernel=(4, 4), stride=(2, 2),
                               pad=(1, 1), num_filter=nf, no_bias=True)
        d = mt.sym.BatchNorm(d, name=f"dbn{i}", fix_gamma=True, eps=eps)
        d = mt.sym.LeakyReLU(d, name=f"dact{i}", act_type="leaky",
                             slope=0.2)
    d = mt.sym.Convolution(d, name="d4", kernel=(4, 4), num_filter=1,
                           no_bias=True)
    d = mt.sym.LogisticRegressionOutput(data=mt.sym.Flatten(d),
                                        label=mt.sym.Variable("label"),
                                        name="dloss")
    return g, d


def svm_sym(mt):
    """svm_digits.py svm_net."""
    h = mt.sym.FullyConnected(mt.sym.Variable("data"), num_hidden=128,
                              name="fc1")
    h = mt.sym.Activation(h, act_type="relu")
    h = mt.sym.FullyConnected(h, num_hidden=10, name="fc2")
    return mt.sym.SVMOutput(h, name="svm")


def _module(mt, sym, ctx, data_shapes, label_shapes, init, opt, opt_params,
            seed, inputs_need_grad=False, params=None):
    """A bound Module with its optimizer, its parameters from ``init`` or
    from ``params`` (numpy (args, aux))."""
    mod = mt.mod.Module(sym, data_names=[n for n, _ in data_shapes],
                        label_names=[n for n, _ in label_shapes] or None,
                        context=ctx)
    mod.bind(data_shapes=data_shapes, label_shapes=label_shapes or None,
             inputs_need_grad=inputs_need_grad)
    mt.random.seed(seed)
    if params is None:
        mod.init_params(init)
    else:
        mod.init_params(arg_params={k: mt.nd.array(v, ctx=mt.cpu())
                                    for k, v in params[0].items()},
                        aux_params={k: mt.nd.array(v, ctx=mt.cpu())
                                    for k, v in params[1].items()})
    mod.init_optimizer(optimizer=opt, optimizer_params=dict(opt_params))
    return mod


def _params_np(mod):
    a, x = mod.get_params()
    return ({k: v.asnumpy() for k, v in a.items()},
            {k: v.asnumpy() for k, v in x.items()})


def heads_ae(mt, ctx, epochs, params=None, steps=None):
    """stacked_ae.py's finetune stage; (MSE before, MSE after, module)."""
    x, _ = digits_like(SEED + 70)
    np.random.seed(SEED + 69)       # NDArrayIter's shuffle
    it = mt.io.NDArrayIter(x, x, 100, shuffle=True,
                           last_batch_handle="discard",
                           label_name="recon_label")
    mod = _module(mt, ae_sym(mt), ctx, it.provide_data, it.provide_label,
                  mt.initializer.Xavier(), "adam", {"learning_rate": 1e-3},
                  SEED + 71, params=params and params[0])

    def mse():
        ev = mt.io.NDArrayIter(x, x, 100, label_name="recon_label")
        out = mod.predict(ev).asnumpy()
        return float(((out - x[:len(out)]) ** 2).mean())
    return _fit_loop(mod, it, epochs, steps, mse)


def _fit_loop(mod, it, epochs, steps, metric):
    before = metric()
    done = 0
    for _ in range(epochs):
        it.reset()
        for b in it:
            mod.forward(b, is_train=True)
            mod.backward()
            mod.update()
            done += 1
            if steps is not None and done >= steps:
                return before, metric(), mod
    return before, metric(), mod


def mf_ratings(seed, users=200, items=100, n=8000, rank=4, noise=0.1):
    """matrix_fact.py make_ratings."""
    rng = np.random.default_rng(seed)
    U = rng.standard_normal((users, rank)) / np.sqrt(rank)
    V = rng.standard_normal((items, rank)) / np.sqrt(rank)
    u = rng.integers(0, users, n)
    i = rng.integers(0, items, n)
    r = (U[u] * V[i]).sum(1) + noise * rng.standard_normal(n)
    return (u.astype(np.float32), i.astype(np.float32),
            r.astype(np.float32))


def heads_mf(mt, ctx, epochs, params=None, steps=None):
    """matrix_fact.py through Module; (val RMSE before, after, module)."""
    u, i, r = mf_ratings(SEED + 72)
    nt = int(0.9 * len(r))
    np.random.seed(SEED + 73)
    it = mt.io.NDArrayIter({"user": u[:nt], "item": i[:nt]},
                           {"score": r[:nt]}, batch_size=256, shuffle=True,
                           last_batch_handle="discard")
    mod = _module(mt, mf_sym(mt), ctx, it.provide_data, it.provide_label,
                  mt.initializer.Normal(0.3), "adam",
                  {"learning_rate": 0.02}, SEED + 74,
                  params=params and params[0])

    def rmse():
        ev = mt.io.NDArrayIter({"user": u[nt:], "item": i[nt:]},
                               {"score": r[nt:]}, batch_size=256)
        out = mod.predict(ev).asnumpy().reshape(-1)
        return float(np.sqrt(((out - r[nt:][:len(out)]) ** 2).mean()))
    return _fit_loop(mod, it, epochs, steps, rmse)


def heads_svm(mt, ctx, epochs, params=None, steps=None):
    """svm_digits.py through Module; (test accuracy before, after)."""
    x, y = digits_like(SEED + 75)
    n = 1500
    np.random.seed(SEED + 76)
    it = mt.io.NDArrayIter(x[:n], y[:n], 100, shuffle=True,
                           last_batch_handle="discard",
                           label_name="svm_label")
    mod = _module(mt, svm_sym(mt), ctx, it.provide_data, it.provide_label,
                  mt.initializer.Xavier(), "sgd",
                  {"learning_rate": 0.1, "momentum": 0.9, "wd": 1e-4},
                  SEED + 77, params=params and params[0])

    def acc():
        ev = mt.io.NDArrayIter(x[n:], y[n:], 100, label_name="svm_label")
        out = mod.predict(ev).asnumpy()
        return float((out.argmax(1) == y[n:][:len(out)]).mean())
    return _fit_loop(mod, it, epochs, steps, acc)


def heads_dcgan(mt, ctx, epochs, params=None, steps=None, batch=64,
                zdim=32):
    """dcgan_digits.py's two-module loop; (the first epoch's mean
    discriminator loss, the last epoch's, (modG, modD))."""
    x, _ = digits_like(SEED + 78)
    x = x.reshape(-1, 8, 8).repeat(4, 1).repeat(4, 2)[:, None] * 2 - 1
    rng = np.random.default_rng(SEED + 79)
    symG, symD = dcgan_syms(mt)
    adam = {"learning_rate": 2e-4, "beta1": 0.5}
    modG = _module(mt, symG, ctx, [("rand", (batch, zdim, 1, 1))], [],
                   mt.initializer.Normal(0.02), "adam", adam, SEED + 80,
                   params=params and params[0])
    modD = _module(mt, symD, ctx, [("data", (batch, 1, 32, 32))],
                   [("label", (batch,))], mt.initializer.Normal(0.02),
                   "adam", adam, SEED + 81, inputs_need_grad=True,
                   params=params and params[1])
    ones = mt.nd.ones((batch,), ctx=mt.cpu())
    zeros = mt.nd.zeros((batch,), ctx=mt.cpu())
    d_losses, done = [float("nan")], 0
    for _ in range(epochs):
        perm = rng.permutation(len(x))
        epoch = []
        for i in range(len(x) // batch):
            real = mt.nd.array(x[perm[i * batch:(i + 1) * batch]],
                               ctx=mt.cpu())
            noise = mt.nd.array(rng.standard_normal(
                (batch, zdim, 1, 1)).astype(np.float32), ctx=mt.cpu())
            modG.forward(mt.io.DataBatch(data=[noise]), is_train=True)
            fake = modG.get_outputs()[0]
            modD.forward(mt.io.DataBatch(data=[fake], label=[zeros]),
                         is_train=True)
            pf = modD.get_outputs()[0].asnumpy()
            modD.backward()
            modD.update()
            modD.forward(mt.io.DataBatch(data=[real], label=[ones]),
                         is_train=True)
            pr = modD.get_outputs()[0].asnumpy()
            modD.backward()
            modD.update()
            modD.forward(mt.io.DataBatch(data=[fake], label=[ones]),
                         is_train=True)
            modD.backward()
            modG.backward(out_grads=modD.get_input_grads())
            modG.update()
            epoch.append(float(-(np.log(pr + 1e-7).mean()
                                 + np.log(1 - pf + 1e-7).mean())))
            done += 1
            if steps is not None and done >= steps:
                return epoch[0], epoch[-1], (modG, modD)
        d_losses.append(float(np.mean(epoch)))
    return d_losses[min(1, epochs)], d_losses[-1], (modG, modD)


# metric, whether it should fall ("min") or rise ("max"), runner
HEADS = {"stacked_ae": ("recon_mse", "min", heads_ae),
         "matrix_fact": ("val_rmse", "min", heads_mf),
         "dcgan": ("d_loss", "min", heads_dcgan),
         "svm": ("test_acc", "max", heads_svm)}


def heads_params(mt, name, ctx, params=None, steps=0):
    """Each module's parameters of example ``name`` after ``steps`` fp32
    steps from ``params`` (a list of numpy (args, aux), one a module; the
    example's own initialization when None)."""
    _, _, mod = HEADS[name][2](mt, ctx, 1 if steps else 0, params=params,
                               steps=steps or None)
    mods = mod if isinstance(mod, tuple) else (mod,)
    return [_params_np(m) for m in mods]


def heads_step_diff(card, cpu):
    """The largest difference of the card's parameters after the step
    from the CPU's, over the largest value."""
    worst = 0.0
    for (ga, gx), (ca, cx) in zip(card, cpu):
        for g, c in ((ga, ca), (gx, cx)):
            for k in c:
                scale = max(float(np.abs(c[k]).max()), 1e-30)
                worst = max(worst, float(np.abs(g[k] - c[k]).max()) / scale)
    return worst


def phase_module_heads(torch, mt):
    """The four examples' graphs trained through Module on cuda:0 in
    fp32, each with the launch and dispatch counts reset before and read
    after; then one fp32 step each, card against CPU."""
    rows, fails = {}, []
    for name, (metric, sense, run) in HEADS.items():
        reset_counts(mt)
        t0 = time.monotonic()
        before, after, _ = run(mt, mt.gpu(0), HEADS_EPOCHS[name])
        secs = time.monotonic() - t0
        counts = read_counts(mt)
        dispatch = mt.profiler.dispatch_counts()
        gain = (before - after) if sense == "min" else (after - before)
        init = heads_params(mt, name, mt.cpu())
        card = heads_params(mt, name, mt.gpu(0), init, steps=1)
        cpu = heads_params(mt, name, mt.cpu(), init, steps=1)
        diff = heads_step_diff(card, cpu)
        rows[name] = dict(metric=metric, epochs=HEADS_EPOCHS[name],
                          before=before, after=after, gain=gain,
                          margin=HEADS_MARGIN[name], seconds=secs,
                          dispatches=dispatch, kernel_launches=counts,
                          fp32_step_rel_diff=diff)
        if not np.isfinite(after) or not gain > HEADS_MARGIN[name]:
            fails.append(f"{name}: {metric} {before} -> {after} does not "
                         f"improve by {HEADS_MARGIN[name]}")
        if not dispatch.get("module.update") or any(counts.values()):
            fails.append(f"{name}: dispatches {dispatch}, kernel launches "
                         f"{counts} (want updates, no kernel)")
        if not diff <= HEADS_STEP_RTOL:
            fails.append(f"{name}: one fp32 step differs from the CPU's by "
                         f"{diff} of the largest value (> "
                         f"{HEADS_STEP_RTOL})")
    emit("module_heads", float32=True, step_rtol=HEADS_STEP_RTOL,
         failures=fails, **rows)
    if fails:
        raise RuntimeError("module_heads: " + "; ".join(fails))


def dense_op_cases(rng):
    """(name, inputs as numpy, attributes, indices of the inputs that take
    a gradient): each op of the slice at a shape a user gives it."""
    act = rng.standard_normal((16, 256, 56, 56)).astype(np.float32)
    fc = rng.standard_normal((256, 1000)).astype(np.float32)
    lab = rng.integers(0, 1000, 256).astype(np.float32)
    sig = rng.uniform(0.05, 0.95, (256, 1024)).astype(np.float32)
    return [
        ("UpSampling", [act], {"scale": 2}, (0,)),
        ("UpSampling", [act, act], {"scale": 2, "num_args": 2,
                                    "multi_input_mode": "sum"}, (0, 1)),
        ("space_to_depth", [act], {"block_size": 2}, (0,)),
        ("depth_to_space", [act], {"block_size": 2}, (0,)),
        ("Crop", [act, act[:, :, :48, :48]], {"num_args": 2,
                                              "center_crop": True}, (0,)),
        ("_slice_assign", [act, act[:, :64, 8:40, 8:40] * 2],
         {"begin": (0, 0, 8, 8), "end": (16, 64, 40, 40)}, (0, 1)),
        ("_slice_assign_scalar", [act], {"scalar": 0.5, "begin": (0, 0),
                                         "end": (16, 128)}, (0,)),
        ("LinearRegressionOutput", [fc, fc[::-1].copy()], {}, (0,)),
        ("MAERegressionOutput", [fc, fc[::-1].copy()], {}, (0,)),
        ("LogisticRegressionOutput", [fc, (fc > 0).astype(np.float32)],
         {}, (0,)),
        ("SVMOutput", [fc, lab], {"margin": 1.0}, (0,)),
        ("softmax_cross_entropy", [fc, lab], {}, (0,)),
        ("IdentityAttachKLSparseReg", [sig, sig.mean(0)], {"is_train": True},
         (0,)),
        ("diag", [fc[:, :256]], {"k": 1}, (0,)),
        ("_scatter_set_nd", [fc, fc[:4].reshape(-1),
                             np.stack([rng.integers(0, 256, 4000),
                                       rng.integers(0, 1000, 4000)])
                             .astype(np.float32)], {"shape": fc.shape},
         (0, 1)),
        ("shape_array", [act], {}, ()),
        ("size_array", [act], {}, ()),
        ("cast_storage", [act], {"stype": "default"}, ()),
        ("_eye", [], {"N": 1024, "k": 1}, ()),
        ("_linspace", [], {"start": -1.0, "stop": 1.0, "num": 4096}, ()),
    ]


DENSE_OP_RTOL = 1e-6


def dense_op_run(torch, mt, name, arrays, attrs, grad, device, cot_seed):
    """(outputs, gradients) of one op on ``device`` as numpy; the
    gradient of sum(out * c) for a seeded cotangent c."""
    from mxnet_tpu_torch.ops import registry
    ins = [torch.from_numpy(a).to(device) for a in arrays]
    for i in grad:
        ins[i].requires_grad_()
    kw = dict(attrs)
    if not arrays:
        kw["device"] = device
    out = registry.get(name)(*ins, **kw)
    outs = list(out) if isinstance(out, (tuple, list)) else [out]
    grads = []
    if grad:
        gen = torch.Generator().manual_seed(cot_seed)
        cot = torch.randn(outs[0].shape, generator=gen).to(device)
        outs[0].backward(cot.to(outs[0].dtype))
        grads = [ins[i].grad.cpu().numpy() for i in grad]
    return [o.detach().cpu().numpy() for o in outs], grads


def phase_dense_ops(torch, mt):
    """Each op the slice ported, once on the card against the same op on
    the CPU, forward and gradient: ops that move or pick elements
    exactly, the others within DENSE_OP_RTOL of the largest value."""
    rng = np.random.default_rng(SEED + 90)
    rows, fails = {}, []
    # UpSampling's gradient sums each block of scale^2 in an order of its
    # device's own; every other listed op moves, picks or writes values
    exact = {"space_to_depth", "depth_to_space", "Crop",
             "_slice_assign", "_slice_assign_scalar", "diag",
             "_scatter_set_nd", "shape_array", "size_array", "cast_storage",
             "_eye", "LinearRegressionOutput", "MAERegressionOutput",
             "SVMOutput"}
    for i, (name, arrays, attrs, grad) in enumerate(dense_op_cases(rng)):
        key = f"{name}_{i}"
        t0 = time.monotonic()
        g_out, g_grad = dense_op_run(torch, mt, name, arrays, attrs, grad,
                                     torch.device("cuda", 0), i)
        torch.cuda.synchronize()
        gpu_s = time.monotonic() - t0
        c_out, c_grad = dense_op_run(torch, mt, name, arrays, attrs, grad,
                                     torch.device("cpu"), i)
        worst = 0.0
        for g, c in zip(g_out + g_grad, c_out + c_grad):
            if g.shape != c.shape or g.dtype != c.dtype:
                fails.append(f"{key}: {g.shape} {g.dtype} on the card, "
                             f"{c.shape} {c.dtype} on the CPU")
                continue
            gf, cf = g.astype(np.float64), c.astype(np.float64)
            scale = max(float(np.abs(cf).max()), 1e-30)
            worst = max(worst, float(np.abs(gf - cf).max()) / scale)
        lim = 0.0 if name in exact else DENSE_OP_RTOL
        rows[key] = dict(shapes=[list(a.shape) for a in arrays],
                         out_shape=list(g_out[0].shape), rel_diff=worst,
                         limit=lim, gpu_s=gpu_s)
        if not worst <= lim:
            fails.append(f"{key}: card vs CPU {worst} > {lim}")
    emit("dense_ops", failures=fails, **rows)
    if fails:
        raise RuntimeError("dense_ops: " + "; ".join(fails))


# --------------------------------------------------------------------------
# C1.b.2: a GShard-style MoE GPT-2-small LM with the chunked CE head
# --------------------------------------------------------------------------
# GPT-2 small's widths (GPT2_SMALL) with a mixture of 8 gelu experts in
# every layer's FFN, top-2 gating (GShard, Lepikhin et al. 2020) at the
# op's default capacity factor 2.0 (C = 2.0 * T * 2 / 8: 4096 slots an
# expert at batch 8 x 1024), and the chunked cross-entropy head over
# benchmark/transformer_bench.py's 8 vocabulary chunks
MOE = dict(GPT2_SMALL, moe_experts=8, moe_k=2, loss_type="chunked_ce",
           ce_chunks=8)
MOE_BATCH = 8
MOE_WARMUP = 3
MOE_STEPS = 10
MOE_LR = 3e-4
# the last loss must beat the first by MOE_MARGIN nats (the phase's loop:
# Adam lr 3e-4, Xavier gaussian magnitude 2, one batch of lm_batch's
# rule), fixed before the first card run from the CPU rehearsal
# (tests/torch_numerics.py c1b2: the same 13 steps in fp32 at 2 layers
# and batch 1 fell 4.57 nats): a fifth of that, rounded
MOE_MARGIN = 1.0
# one fp32 SGD step at MOE_FP32_LAYERS layers, batch 1, card (TF32 off)
# against the CPU from the same numpy weights: the loss within 1e-4 nats
# and each parameter's update within 2e-3 of that update's largest
# element (the rehearsal's fp32 step against float64: 2.1e-7 and 3.3e-4,
# LayerNorm's gamma; card and CPU are two such fp32 errors, 3x margin);
# every token's two experts must be the same on both devices (no token
# changed its experts between fp32 and float64 in the rehearsal)
MOE_FP32_LAYERS = 2
MOE_FP32_LR = 0.1
MOE_FP32_LOSS_TOL = 1e-4
MOE_FP32_UPDATE_RTOL = 2e-3
# the MoE decode step (fp32) at batch 32 against the MoE LM's
# teacher-forced log-probabilities (fp32, seq MOE_DECODE_POSITIONS, the
# same 32 sequences), at GPT-2's initialisation (gpt2_init_params), over
# the sequences no MoE call of either run dropped a token of; at least
# half of them must be compared.  The decode routes the 32 tokens of one
# position a call (capacity 16 an expert), which share the position's
# embedding and so lean to the same experts: the CPU rehearsal at full
# depth dropped tokens of 11 of the 32 sequences, the LM's calls
# (capacity 256) of 4 (with wpe at 0.02 in place of GPT-2's 0.01 and
# another seed, 14 and 8).  The log-probabilities of the 21 others
# agreed within 3.7e-6; 1e-4 for the card's reduction orders (K1
# against batch_dot and softmax)
MOE_DECODE_BATCH = 32
MOE_DECODE_POSITIONS = 16
MOE_DECODE_LOGP_TOL = 1e-4


def gpt2_init_params(sym, seed):
    """Seeded weights at GPT-2's initialisation (the released model.py of
    openai/gpt-2: wte and every matrix N(0, 0.02), wpe N(0, 0.01), biases
    0, LayerNorm gamma 1 and beta 0), as numpy."""
    shapes, _, _ = sym.infer_shape(data=(1, GPT2_SMALL["seq_len"]),
                                   softmax_label=(1, GPT2_SMALL["seq_len"]))
    rng = np.random.default_rng(seed)
    params = {}
    for name, shape in zip(sym.list_arguments(), shapes):
        if name in ("data", "softmax_label"):
            continue
        if name.endswith("_gamma"):
            params[name] = np.ones(shape, np.float32)
        elif name.endswith(("_beta", "_bias")):
            params[name] = np.zeros(shape, np.float32)
        else:
            std = 0.01 if name == "pos_embed_weight" else 0.02
            params[name] = rng.standard_normal(shape, dtype=np.float32) \
                * np.float32(std)
    return params


def moe_module(mt, ctx, cfg, batch, compute_dtype=None, for_training=True):
    """The MoE LM of ``cfg`` bound through Module for int32 ids and
    labels (batch, seq)."""
    S = cfg["seq_len"]
    mod = mt.mod.Module(mt.models.transformer_lm(**cfg), context=ctx,
                        compute_dtype=compute_dtype)
    mod.bind([mt.io.DataDesc("data", (batch, S), np.int32)],
             [mt.io.DataDesc("softmax_label", (batch, S), np.int32)],
             for_training=for_training)
    return mod


def moe_step_flops(cfg, batch, capacity):
    """Multiply-adds x 2 of one training step, counted from the products
    it dispatches: per layer QKV, the output projection, the router, the
    two expert products over all E x C slots (full or not) and the
    attention products (S^2, as transformer_bench.py counts them), the
    backward twice the forward; the chunked head's forward, its
    recomputation and its two gradient products over the whole
    vocabulary."""
    S, D, F, E, L, V = (cfg[k] for k in ("seq_len", "d_model", "d_ff",
                                         "moe_experts", "num_layers",
                                         "vocab_size"))
    T = batch * S
    layer = (2 * T * D * 3 * D + 2 * T * D * D + 2 * T * D * E
             + 2 * 2 * E * capacity * D * F + 4 * batch * S * S * D)
    return 3.0 * L * layer + 4 * 2.0 * T * V * D


def moe_lm_logprobs(mt, params, toks, ctx):
    """(log-probabilities (B, S, V), the sequences any MoE call dropped a
    token of): the MoE LM with the softmax head, fp32, teacher-forced."""
    from mxnet_tpu_torch.ops import moe
    B, S = toks.shape
    cfg = dict(MOE, seq_len=S, max_len=GPT2_SMALL["seq_len"],
               loss_type="softmax")
    mod = moe_module(mt, ctx, cfg, B, for_training=False)
    mod.init_params(arg_params=params)
    with moe.collect_routing() as st:
        mod.forward(mt.io.DataBatch([mt.nd.array(toks, ctx=mt.cpu())],
                                    [mt.nd.array(np.zeros_like(toks),
                                                 ctx=mt.cpu())]),
                    is_train=False)
        probs = mod.get_outputs()[0].asnumpy().reshape(B, S, -1)
    dropped = np.zeros(B, bool)
    for mask in st["dropped_tokens"]:       # tokens in (b, s) order
        dropped |= mask.numpy().reshape(B, S).any(1)
    return log_probs(probs), dropped, st


def moe_decode_logprobs(mt, params, toks, ctx):
    """(log-softmax of each step's logits (B, S, V), the sequences any
    MoE call dropped a token of): the MoE decode step at batch B, fp32,
    one position a step."""
    from mxnet_tpu_torch.ops import moe
    B, S = toks.shape
    cfg = {k: v for k, v in MOE.items()
           if k not in ("vocab_size", "seq_len", "loss_type", "ce_chunks")}
    dec = mt.models.transformer_decode_step(
        MOE["vocab_size"], GPT2_SMALL["seq_len"], B, **cfg)
    mod = mt.mod.Module(dec, context=ctx, data_names=("data",),
                        label_names=None,
                        state_names=decode_state_names(cfg["num_layers"]))
    mod.bind(data_shapes=[("data", (B,))], for_training=False)
    mod.init_params(arg_params=params)
    mod.set_states(value=0)
    out = []
    with moe.collect_routing() as st:
        for t in range(S):
            tok = mt.nd.array(toks[:, t].astype(np.float32), ctx=mt.cpu())
            out.append(log_softmax_np(decode_step(mt, mod, tok).asnumpy()))
    dropped = np.zeros(B, bool)
    for mask in st["dropped_tokens"]:       # one token a sequence
        dropped |= mask.numpy()
    return np.stack(out, 1), dropped, st


def moe_decode_vs_lm(mt, ctx):
    """The decode step against the teacher-forced LM on the same
    MOE_DECODE_BATCH sequences, at GPT-2's initialisation: the largest
    log-prob difference over the sequences neither run dropped a token
    of, and the drop counts."""
    V = MOE["vocab_size"]
    params = gpt2_init_params(mt.models.transformer_lm(**dict(
        MOE, loss_type="softmax")), SEED + 74)
    toks = np.random.default_rng(SEED + 71).integers(
        0, V, (MOE_DECODE_BATCH, MOE_DECODE_POSITIONS), dtype=np.int32)
    ref, lm_drop, lm_st = moe_lm_logprobs(mt, params, toks, ctx)
    got, dec_drop, dec_st = moe_decode_logprobs(mt, params, toks, ctx)
    keep = ~(lm_drop | dec_drop)
    diffs = np.abs(got - ref).max(axis=(1, 2))
    return dict(batch=MOE_DECODE_BATCH, positions=MOE_DECODE_POSITIONS,
                lm_capacity=lm_st["capacity"],
                decode_capacity=dec_st["capacity"],
                lm_dropped_choices=lm_st["dropped"],
                decode_dropped_choices=dec_st["dropped"],
                lm_dropped_sequences=int(lm_drop.sum()),
                decode_dropped_sequences=int(dec_drop.sum()),
                compared_sequences=int(keep.sum()),
                max_abs_logp_diff=float(diffs[keep].max()) if keep.any()
                else None,
                logp_diff_of_dropped=float(diffs[~keep].max())
                if (~keep).any() else None)


def moe_fp32_step(mt, ctx, params, x, y):
    """One fp32 SGD step of the MoE LM at MOE_FP32_LAYERS layers: (loss,
    new parameters, every layer's (T, k) experts, seconds)."""
    from mxnet_tpu_torch.ops import moe
    cfg = dict(MOE, num_layers=MOE_FP32_LAYERS)
    mod = moe_module(mt, ctx, cfg, x.shape[0])
    mod.init_params(arg_params=params)
    mod.init_optimizer(optimizer="sgd",
                       optimizer_params={"learning_rate": MOE_FP32_LR})
    batch = mt.io.DataBatch([mt.nd.array(x, ctx=mt.cpu())],
                            [mt.nd.array(y, ctx=mt.cpu())])
    t0 = time.monotonic()
    with moe.collect_routing() as st:
        train_step(mod, batch)
        loss = float(mod.get_outputs()[0].asnumpy())
    secs = time.monotonic() - t0
    new = {n: a.asnumpy() for n, a in mod.get_params()[0].items()}
    return loss, new, [e.numpy() for e in st["experts"]], secs


def moe_fp32_compare(card, cpu, params):
    """The loss difference, the worst parameter's update difference
    relative to its largest element, and the tokens whose two experts
    differ."""
    worst, worst_name = 0.0, None
    for n, w in params.items():
        dg, dc = card[1][n] - w, cpu[1][n] - w
        rel = float(np.abs(dg - dc).max() / max(np.abs(dc).max(), 1e-30))
        if not np.isfinite(card[1][n]).all():
            rel = float("inf")
        if rel >= worst:
            worst, worst_name = rel, n
    flips = sum(int((a != b).any(1).sum()) for a, b in zip(card[2], cpu[2]))
    return dict(loss_diff=abs(card[0] - cpu[0]), worst_update_rel_diff=worst,
                worst_param=worst_name, routing_differs_tokens=flips)


class NoTensorOf:
    """A TorchDispatchMode recording the largest tensor any op makes
    (``largest``), to show that no tensor of ``numel`` elements or more is
    ever made."""

    def __init__(self, torch):
        from torch.utils._python_dispatch import TorchDispatchMode

        outer = self
        outer.largest = 0

        class _Spy(TorchDispatchMode):
            def __torch_dispatch__(self, func, types, args=(), kwargs=None):
                out = func(*args, **(kwargs or {}))
                for o in (out if isinstance(out, (tuple, list)) else (out,)):
                    if isinstance(o, torch.Tensor):
                        outer.largest = max(outer.largest, o.numel())
                return out
        self._mode = _Spy()

    def __enter__(self):
        self._mode.__enter__()
        return self

    def __exit__(self, *exc):
        return self._mode.__exit__(*exc)


def moe_head_memory(torch, mt, params, batch):
    """Bytes above the bound model that one bf16 forward and backward of
    the MoE LM needs at its peak, with the chunked head and with the
    SoftmaxOutput head, from the same parameters."""
    rows = {}
    for head in ("chunked_ce", "softmax"):
        mod = moe_module(mt, mt.gpu(0), dict(MOE, loss_type=head),
                         MOE_BATCH, "bfloat16")
        mod.init_params(arg_params=params)
        torch.cuda.synchronize()
        base = torch.cuda.memory_allocated()
        torch.cuda.reset_peak_memory_stats()
        mod.forward(batch, is_train=True)
        mod.backward()
        torch.cuda.synchronize()
        rows[head] = torch.cuda.max_memory_allocated() - base
        del mod
        torch.cuda.empty_cache()
    return rows


def phase_moe_lm_train(torch, mt, peak_flops):
    """The MoE GPT-2-small LM (MOE) trained through Module on cuda:0, bf16
    over fp32 masters, Adam: first the decode step against the
    teacher-forced LM (moe_decode_vs_lm, GPT-2's initialisation); then the
    training path, launch counts reset just before the MOE_WARMUP +
    MOE_STEPS steps and read just after; then one step collecting the
    routing under a dispatch spy (no (B*S, V) tensor), one under
    torch.profiler, and the two heads' memory."""
    S, V, L, D, E, K = (MOE[k] for k in ("seq_len", "vocab_size",
                                         "num_layers", "d_model",
                                         "moe_experts", "moe_k"))
    B = MOE_BATCH
    x, y = lm_batch(np.random.default_rng(SEED + 70), B, S, V)
    t0 = time.monotonic()
    mod = moe_module(mt, mt.gpu(0), MOE, B, "bfloat16")
    mt.random.seed(SEED)
    mod.init_params(mt.initializer.Xavier(rnd_type="gaussian",
                                          magnitude=2.0))
    mod.init_optimizer(optimizer="adam",
                       optimizer_params={"learning_rate": MOE_LR})
    batch = mt.io.DataBatch([mt.nd.array(x, ctx=mt.cpu())],
                            [mt.nd.array(y, ctx=mt.cpu())])
    args, _ = mod.get_params()
    n_params = sum(int(np.prod(a.shape)) for a in args.values())
    n_expert = sum(int(np.prod(a.shape)) for n, a in args.items()
                   if "_expert_" in n)
    torch.cuda.synchronize()
    setup_s = time.monotonic() - t0

    # the decode step against the LM, fp32
    t0 = time.monotonic()
    dec = moe_decode_vs_lm(mt, mt.gpu(0))
    dec["seconds"] = time.monotonic() - t0
    torch.cuda.empty_cache()

    # the training path: counts start at 0 here and are read right after
    torch.cuda.reset_peak_memory_stats()
    reset_counts(mt)
    losses, step_ms = [], []
    n = MOE_WARMUP + MOE_STEPS
    for _ in range(n):
        t = time.monotonic()
        train_step(mod, batch)
        losses.append(float(mod.get_outputs()[0].asnumpy()))
        torch.cuda.synchronize()
        step_ms.append((time.monotonic() - t) * 1e3)
    counts = read_counts(mt)
    dispatch = mt.profiler.dispatch_counts()
    peak = torch.cuda.max_memory_allocated()

    # one more step: the routing's counts, and the largest tensor made
    from mxnet_tpu_torch.ops import moe
    with moe.collect_routing() as st, NoTensorOf(torch) as spy:
        train_step(mod, batch)
        torch.cuda.synchronize()
    load = st["load"].numpy() / (L * B * S * K)    # share of the choices

    torch.cuda.synchronize()
    with device_window(torch) as prof:
        t = time.monotonic()
        train_step(mod, batch)
        torch.cuda.synchronize()
        prof_step_ms = (time.monotonic() - t) * 1e3
    kernels = device_kernels(prof)
    busy = sum(k[0] for k in kernels)
    attn_ms = {stem: sum(k[0] for k in kernels if stem in k[2])
               for stem in ("flash_fwd", "flash_bwd_dq", "flash_bwd_dkv")}

    params_now = {k: a for k, a in mod.get_params()[0].items()}
    del mod
    torch.cuda.empty_cache()
    head_mem = moe_head_memory(torch, mt, params_now, batch)
    del params_now
    torch.cuda.empty_cache()

    C = st["capacity"]
    flops = moe_step_flops(MOE, B, C)
    timed = step_ms[MOE_WARMUP:]
    med = float(np.median(timed))
    fails = []
    want = {"flash_fwd": L * n, "flash_fwd_lse": L * n,
            "flash_bwd_dq": L * n, "flash_bwd_dkv": L * n,
            "nms_suppress": 0}
    if counts != want or dispatch.get("module.update") != n \
            or dispatch.get("module.backward") != n:
        fails.append(f"launches {counts} / dispatches {dispatch} over {n} "
                     f"steps, want {want} and {n} updates and backwards")
    if not all(np.isfinite(losses)):
        fails.append(f"non-finite loss in {losses}")
    elif not losses[-1] < losses[0] - MOE_MARGIN:
        fails.append(f"last loss {losses[-1]} does not beat the first "
                     f"{losses[0]} by {MOE_MARGIN}")
    if spy.largest >= B * S * V:
        fails.append(f"a tensor of {spy.largest} elements was made (B*S*V "
                     f"= {B * S * V})")
    if not all(attn_ms.values()):
        fails.append(f"the profiled step shows {attn_ms}")
    comp = dec["compared_sequences"]
    if comp < MOE_DECODE_BATCH / 2 or dec["max_abs_logp_diff"] is None \
            or not dec["max_abs_logp_diff"] <= MOE_DECODE_LOGP_TOL:
        fails.append(f"decode vs LM: {dec['max_abs_logp_diff']} over "
                     f"{comp} sequences (tol {MOE_DECODE_LOGP_TOL}, at "
                     f"least {MOE_DECODE_BATCH // 2})")
    emit("moe_lm_train", model="gpt2-small-width moe", layers=L,
         experts=E, top_k=K, capacity=C, head=f"chunked_ce x "
         f"{MOE['ce_chunks']}", batch=B, seq=S, vocab=V,
         compute_dtype="bfloat16", masters="float32",
         optimizer=f"adam lr {MOE_LR}",
         initializer="xavier gaussian magnitude 2", setup_s=setup_s,
         n_params=n_params, n_expert_params=n_expert, warmup=MOE_WARMUP,
         steps=MOE_STEPS, losses=losses, margin=MOE_MARGIN,
         step_ms=timed, median_step_ms=med, min_step_ms=min(timed),
         max_step_ms=max(timed), tokens_per_s=B * S / (med / 1e3),
         flops_per_step=flops, achieved_tflops=flops / (med / 1e3) / 1e12,
         mfu=flops / (med / 1e3) / peak_flops, peak_mem_bytes=peak,
         dropped_choice_share=st["dropped"] / st["choices"],
         expert_load_share=[float(v) for v in load],
         largest_tensor_elements=spy.largest, bsv=B * S * V,
         head_peak_bytes=head_mem, launches=counts, dispatches=dispatch,
         decode_vs_lm=dict(dec, tol=MOE_DECODE_LOGP_TOL), failures=fails)
    emit("moe_lm_profile", step_ms=prof_step_ms, device_busy_ms=busy,
         device_idle_share_of_step=max(0.0, 1 - busy / prof_step_ms),
         device_idle_share_of_median_step=max(0.0, 1 - busy / med),
         flash_fwd_ms=attn_ms["flash_fwd"],
         flash_bwd_dq_ms=attn_ms["flash_bwd_dq"],
         flash_bwd_dkv_ms=attn_ms["flash_bwd_dkv"],
         top_kernels=[dict(ms=ms, count=c, name=k)
                      for ms, c, k in kernels[:16]])
    if fails:
        raise RuntimeError("moe_lm_train: " + "; ".join(fails))
    return counts


def phase_moe_fp32(torch, mt):
    """One fp32 step of the MoE LM at MOE_FP32_LAYERS layers, batch 1,
    card (kernels, TF32 off) against the CPU from the same numpy
    weights."""
    cfg = dict(MOE, num_layers=MOE_FP32_LAYERS)
    S, V = cfg["seq_len"], cfg["vocab_size"]
    params = gpt2_params(mt.models.transformer_lm(**cfg), SEED + 72)
    x, y = lm_batch(np.random.default_rng(SEED + 73), 1, S, V)
    reset_counts(mt)
    card = moe_fp32_step(mt, mt.gpu(0), params, x, y)
    counts = read_counts(mt)
    cpu = moe_fp32_step(mt, mt.cpu(), params, x, y)
    row = moe_fp32_compare(card, cpu, params)
    L = MOE_FP32_LAYERS
    want = {"flash_fwd": L, "flash_fwd_lse": L, "flash_bwd_dq": L,
            "flash_bwd_dkv": L, "nms_suppress": 0}
    emit("moe_fp32_card_vs_cpu", layers=L, batch=1, loss_gpu=card[0],
         loss_cpu=cpu[0], loss_tol=MOE_FP32_LOSS_TOL,
         update_rtol=MOE_FP32_UPDATE_RTOL, gpu_s=card[3], cpu_s=cpu[3],
         launches=counts, **row)
    if counts != want or row["routing_differs_tokens"] \
            or not row["loss_diff"] <= MOE_FP32_LOSS_TOL \
            or not row["worst_update_rel_diff"] <= MOE_FP32_UPDATE_RTOL:
        raise RuntimeError(f"moe fp32: {row}, launches {counts} (want "
                           f"{want})")
    torch.cuda.empty_cache()


# --------------------------------------------------------------------------
# C1.b.2: the other op families, once each at a user's shape, card vs CPU
# --------------------------------------------------------------------------
# linalg: a batch of 32 SPD matrices of 64 x 64 (A = M M^T / 64 + I,
# condition number about 5) through potrf -> potri against inverse, and
# every other linalg op at that size; the card's fp32 (cuSOLVER / cuBLAS,
# TF32 off) and the CPU's fp32 (LAPACK) each against the CPU's float64,
# outputs and the gradient of sum(out * c) for a seeded c, relative to
# the largest value.  The card must be within OPS_LINALG_RTOL: a
# backward-stable fp32 factorisation or solve of a 64 x 64 matrix of
# condition number about 5 is within n u kappa = 64 x 6e-8 x 5 = 2e-5 of
# exact (the CPU rehearsal's fp32: at most 1.2e-6).  syevd's
# eigenvectors, ill-conditioned where 64 eigenvalues crowd into [1, 5]
# (1.2e-3 from float64 on the CPU), are compared through the sign-free
# V^T diag(w) V and w; the gradient through them still divides by the
# eigenvalues' gaps (1.3e-4 on the CPU), so it is held to
# OPS_SYEVD_GRAD_RTOL.  (The first card run held the card to the CPU's
# fp32 at 1e-5, a budget taken from the CPU's distance to float64 alone;
# cuSOLVER's syevd landed 2.4e-5 from LAPACK's, so the check now measures
# each device from float64 and states the bound a stable fp32 routine
# meets.)
OPS_LINALG_RTOL = 1e-4
OPS_SYEVD_GRAD_RTOL = 1e-3
# sampling: OPS_DRAWS draws of each distribution on the card, mean and
# variance within OPS_SE standard errors of the analytic ones
OPS_DRAWS = 10 ** 6
OPS_SE = 5.0
# optimizer ops on a (4096, 4096) float32 weight (bf16 with an fp32
# master for mp_*): card against CPU relative to the largest value (each
# op one elementwise kernel on either device, IEEE single with sqrt and
# division correctly rounded: equal but for an ulp)
OPS_UPDATE_TOL = 1e-6
# CTC at an OCR-like shape (T 80, N 64, 10 symbols + blank, labels of 1 to
# 4 symbols): the card's fp32 loss and gradient against the CPU's float64
# within OPS_CTC_RTOL of the largest value.  The fp32 recursion itself
# sets the error: the gradient is the softmax less the alignments'
# posterior, two near-equal probabilities, and on these inputs the CPU's
# fp32 gradient is 7.7e-5 from float64 (tests/torch_numerics.py c1b2),
# its loss 4.2e-7.  (The first card run held the card to the CPU's fp32
# at 1e-5, from a rehearsal in which the op still computed float64
# inputs in fp32: 1.24e-5 on the gradient.)
OPS_CTC_RTOL = 1e-4
# the custom_softmax example (examples/numpy_ops/custom_softmax.py) on
# digits_like stand-ins, trained through Module.fit on the card for its
# default 10 epochs: the held-out accuracy must gain OPS_CUSTOM_MARGIN, a
# fifth of the CPU rehearsal's 0.08 -> 1.00
OPS_CUSTOM_EPOCHS = 10
OPS_CUSTOM_MARGIN = 0.18


def linalg_cases(rng):
    """(op, inputs, attributes, name): the linalg ops at batch 32 of
    64 x 64 (khatri_rao: three factors of 64 columns)."""
    n, m = 32, 64
    g = rng.standard_normal((n, m, m)).astype(np.float32)
    spd = g @ g.transpose(0, 2, 1) / m + np.eye(m, dtype=np.float32)
    low = np.linalg.cholesky(spd).astype(np.float32)
    b = rng.standard_normal((n, m, m)).astype(np.float32)
    c = rng.standard_normal((n, m, m)).astype(np.float32)
    flip = np.ones((m, 1), np.float32)
    flip[0] = -1                      # a negative determinant
    return [("linalg_potrf", [spd], {}), ("linalg_potri", [low], {}),
            ("linalg_inverse", [spd], {}),
            ("linalg_gemm", [g, b, c], {"transpose_b": True, "alpha": 0.5}),
            ("linalg_gemm2", [g, b], {"transpose_a": True}),
            ("linalg_trmm", [low, b], {"rightside": True}),
            ("linalg_trsm", [low, b], {"transpose": True}),
            ("linalg_syrk", [g], {"alpha": 2.0}),
            ("linalg_sumlogdiag", [low], {}),
            ("linalg_det", [spd], {}),
            ("linalg_slogdet", [spd * flip], {}),
            ("linalg_gelqf", [g[:, :32]], {}), ("linalg_syevd", [spd], {}),
            ("khatri_rao", [g[0], b[0], c[0, :16]], {})]


def linalg_signs(torch, name, outs):
    """gelqf's factors with each row of Q (and L's column) turned so that
    its largest entry is positive (Q's rows are unique only up to sign);
    the other ops' outputs as they are."""
    if name != "linalg_gelqf":
        return outs
    idx = outs[1].abs().argmax(-1, keepdim=True)
    s = torch.sign(outs[1].gather(-1, idx))
    return [outs[0] * s.transpose(-1, -2), outs[1] * s]


def linalg_run(torch, mt, name, arrays, attrs, device, seed):
    """Outputs and the inputs' gradients of sum(out * c) over the
    sign-free outputs (gelqf: L Q; syevd: V^T diag(w) V and w), as
    float64 numpy; gelqf's outputs sign-aligned, syevd's the sign-free
    ones."""
    from mxnet_tpu_torch.ops import registry
    ins = [torch.from_numpy(a).to(device).requires_grad_() for a in arrays]
    out = registry.get(name)(*ins, **attrs)
    outs = list(out) if isinstance(out, (tuple, list)) else [out]
    gen = torch.Generator().manual_seed(seed)
    if name == "linalg_gelqf":      # L Q is free of the signs
        free = [outs[0] @ outs[1]]
    elif name == "linalg_syevd":    # V^T diag(w) V and w are
        free = [outs[0].transpose(-1, -2) @ (outs[1][..., None] * outs[0]),
                outs[1]]
    else:
        free = [o for o in outs if o.is_floating_point()]
    cots = [torch.randn(o.shape, generator=gen).to(device) for o in free]
    torch.autograd.backward(free, cots)
    outs = [o.detach() for o in (free if name == "linalg_syevd" else outs)]
    outs = linalg_signs(torch, name, outs)
    return ([o.double().cpu().numpy() for o in outs],
            [i.grad.double().cpu().numpy() for i in ins])


def rel_diff(a, b):
    """max |a - b| over the largest |b|."""
    return float(np.abs(a - b).max() / max(float(np.abs(b).max()), 1e-30))


# name, kwargs, analytic (mean, variance)
SAMPLERS = {
    "uniform": (dict(low=-1.0, high=3.0), (1.0, 16 / 12)),
    "normal": (dict(loc=2.0, scale=0.5), (2.0, 0.25)),
    "gamma": (dict(alpha=2.5, beta=1.5), (3.75, 2.5 * 1.5 ** 2)),
    "exponential": (dict(scale=2.0), (2.0, 4.0)),
    "poisson": (dict(lam=3.5), (3.5, 3.5)),
    "negative_binomial": (dict(k=3, p=0.4), (4.5, 11.25)),
    "generalized_negative_binomial": (dict(mu=2.0, alpha=0.5), (2.0, 4.0)),
    "randint": (dict(low=-3, high=5), (0.5, 63 / 12)),
}


def moments_within(x, mean, var, se):
    """(z of the mean, z of the variance): their distances from the
    analytic values in standard errors (the variance's from the sample's
    fourth central moment)."""
    x = np.asarray(x, np.float64).ravel()
    m, v = x.mean(), x.var(ddof=1)
    m4 = ((x - m) ** 4).mean()
    return (abs(m - mean) / np.sqrt(var / x.size),
            abs(v - var) / np.sqrt(max(m4 - v * v, 1e-30) / x.size))


def optimizer_cases(rng, shape=(4096, 4096)):
    """(op, inputs, attributes): each update op on a user's weight."""
    w = rng.uniform(-1, 1, shape).astype(np.float32)
    g = rng.uniform(-2, 2, shape).astype(np.float32)

    def st():
        return rng.uniform(0, 0.5, shape).astype(np.float32)
    common = dict(wd=1e-4, rescale_grad=0.5, clip_gradient=0.6)
    return [("sgd_update", [w, g], dict(lr=0.1, **common)),
            ("sgd_mom_update", [w, g, st()], dict(lr=0.1, momentum=0.9,
                                                  **common)),
            ("mp_sgd_update", [w, g, w], dict(lr=0.1, **common)),
            ("mp_sgd_mom_update", [w, g, st(), w],
             dict(lr=0.1, momentum=0.9, **common)),
            ("adam_update", [w, g, st(), st()],
             dict(lr=1e-3, epsilon=1e-6, **common)),
            ("rmsprop_update", [w, g, st()], dict(lr=1e-3, epsilon=1e-6,
                                                 **common)),
            ("rmspropalex_update", [w, g, st(), np.zeros_like(w), st()],
             dict(lr=1e-3, epsilon=1e-6, **common)),
            ("ftrl_update", [w, g, st(), st()], dict(lr=0.1, **common)),
            ("signsgd_update", [w, g], dict(lr=0.1, **common))]


def ctc_inputs(rng, T=80, N=64, C=11, L=4):
    """OCR-like activations (T, N, C) and labels (N, L) of 1 to L symbols
    in 1..C-1, padded with 0 (blank first)."""
    x = rng.standard_normal((T, N, C)).astype(np.float32)
    lab = rng.integers(1, C, (N, L)).astype(np.float32)
    lens = rng.integers(1, L + 1, N)
    lab[np.arange(L)[None, :] >= lens[:, None]] = 0
    return x, lab


def ctc_run(torch, mt, x, lab, device):
    from mxnet_tpu_torch.ops import registry
    d = torch.from_numpy(x).to(device).requires_grad_()
    loss = registry.get("CTCLoss")(d, torch.from_numpy(lab).to(device))
    loss.sum().backward()
    return (loss.detach().double().cpu().numpy(),
            d.grad.double().cpu().numpy())


def custom_softmax_prop(mt):
    """examples/numpy_ops/custom_softmax.py's op, registered in the port
    as ``numpy_softmax``: a softmax loss head in numpy with the backward
    prob - onehot."""

    class NumpySoftmax(mt.operator.CustomOp):
        def forward(self, is_train, req, in_data, out_data, aux):
            x = in_data[0].asnumpy()
            y = np.exp(x - x.max(axis=1, keepdims=True))
            y /= y.sum(axis=1, keepdims=True)
            self.assign(out_data[0], req[0], y)

        def backward(self, req, out_grad, in_data, out_data, in_grad, aux):
            lab = in_data[1].asnumpy().ravel().astype(int)
            y = out_data[0].asnumpy().copy()
            y[np.arange(lab.shape[0]), lab] -= 1.0
            self.assign(in_grad[0], req[0], y)

    @mt.operator.register("numpy_softmax")
    class NumpySoftmaxProp(mt.operator.CustomOpProp):
        def __init__(self):
            super().__init__(need_top_grad=False)

        def list_arguments(self):
            return ['data', 'label']

        def list_outputs(self):
            return ['output']

        def infer_shape(self, in_shape):
            return [in_shape[0], (in_shape[0][0],)], [in_shape[0]], []

        def create_operator(self, ctx, shapes, dtypes):
            return NumpySoftmax()


def custom_softmax_run(mt, ctx, epochs):
    """The example's run (net_symbol, Module.fit with SGD lr 0.1 momentum
    0.9, Xavier, batch 100 over the first 1500 samples) on digits_like:
    (held-out accuracy after init, after training, seconds)."""
    custom_softmax_prop(mt)
    data = mt.sym.Variable('data')
    label = mt.sym.Variable('softmax_label')
    h = mt.sym.FullyConnected(data, num_hidden=64, name='fc1')
    h = mt.sym.Activation(h, act_type='relu')
    h = mt.sym.FullyConnected(h, num_hidden=10, name='fc2')
    net = mt.sym.Custom(h, label, op_type='numpy_softmax', name='softmax')
    x, y = digits_like(SEED + 80)
    np.random.seed(SEED)
    mt.random.seed(SEED)
    train = mt.io.NDArrayIter(x[:1500], y[:1500], 100, shuffle=True,
                              last_batch_handle='discard')
    test = mt.io.NDArrayIter(x[1500:], y[1500:], 100)
    mod = mt.mod.Module(net, context=ctx)
    mod.bind(train.provide_data, train.provide_label)
    mod.init_params(mt.initializer.Xavier())
    before = mod.score(test, 'acc')[0][1]
    t0 = time.monotonic()
    mod.fit(train, num_epoch=epochs, optimizer='sgd',
            optimizer_params={'learning_rate': 0.1, 'momentum': 0.9})
    secs = time.monotonic() - t0
    test.reset()
    return before, mod.score(test, 'acc')[0][1], secs


def phase_ops_c1b2(torch, mt):
    """The slice's other op families on the card: linalg, sampling, the
    optimizer ops and CTC against the CPU (or the analytic moments), and
    the Custom op example trained through Module; the launch counts are
    reset before and read after (none of K1-K4 or N1 runs)."""
    cuda, cpu = torch.device("cuda", 0), torch.device("cpu")
    rows, fails = {}, []
    reset_counts(mt)
    cases = linalg_cases(np.random.default_rng(SEED + 81))
    spd = cases[0][1][0]
    worst = {}
    for i, (name, arrays, attrs) in enumerate(cases):
        g_out, g_grad = linalg_run(torch, mt, name, arrays, attrs, cuda, i)
        c_out, c_grad = linalg_run(torch, mt, name, arrays, attrs, cpu, i)
        r_out, r_grad = linalg_run(torch, mt, name,
                                   [a.astype(np.float64) for a in arrays],
                                   attrs, cpu, i)
        worst[name] = dict(
            out=max(rel_diff(a, b) for a, b in zip(g_out, r_out)),
            grad=max(rel_diff(a, b) for a, b in zip(g_grad, r_grad)),
            cpu_out=max(rel_diff(a, b) for a, b in zip(c_out, r_out)),
            cpu_grad=max(rel_diff(a, b) for a, b in zip(c_grad, r_grad)),
            card_vs_cpu=max(rel_diff(a, b) for a, b in
                            zip(g_out + g_grad, c_out + c_grad)))
        grad_tol = OPS_SYEVD_GRAD_RTOL if name == "linalg_syevd" \
            else OPS_LINALG_RTOL
        if not (worst[name]["out"] <= OPS_LINALG_RTOL
                and worst[name]["grad"] <= grad_tol):
            fails.append(f"{name}: card vs float64 {worst[name]} > "
                         f"{OPS_LINALG_RTOL} / {grad_tol}")
    with torch.no_grad():
        A = mt.nd.array(spd, ctx=mt.gpu(0))
        chain = rel_diff(
            mt.nd.linalg.potri(mt.nd.linalg.potrf(A)).asnumpy(),
            mt.nd.linalg.inverse(A).asnumpy())
    if not chain <= OPS_LINALG_RTOL:
        fails.append(f"potri(potrf(A)) vs inverse(A): {chain}")
    rows["linalg"] = dict(batch=32, size=64, rel_diff=worst,
                          potri_potrf_vs_inverse=chain,
                          rtol=OPS_LINALG_RTOL,
                          syevd_grad_rtol=OPS_SYEVD_GRAD_RTOL)

    ctx = mt.gpu(0)
    samp = {}
    for name, (kw, (mean, var)) in SAMPLERS.items():
        mt.random.seed(SEED + 82)
        a = getattr(mt.nd.random, name)(shape=(OPS_DRAWS,), ctx=ctx, **kw)
        mt.random.seed(SEED + 82)
        again = getattr(mt.nd.random, name)(shape=(OPS_DRAWS,), ctx=ctx,
                                            **kw)
        x = a.asnumpy()
        zm, zv = moments_within(x, mean, var, OPS_SE)
        repeats = bool(np.array_equal(x, again.asnumpy()))
        samp[name] = dict(mean=float(x.mean()), var=float(x.var(ddof=1)),
                          want=[mean, var], z_mean=zm, z_var=zv,
                          reseed_repeats=repeats, device=str(a.context))
        if not (zm <= OPS_SE and zv <= OPS_SE and repeats):
            fails.append(f"{name}: {samp[name]}")
    probs = np.array([0.1, 0.2, 0.3, 0.4], np.float32)
    draw = mt.nd.random.multinomial(mt.nd.array(probs, ctx=ctx),
                                    shape=(OPS_DRAWS,)).asnumpy()
    freq = np.bincount(draw, minlength=4) / OPS_DRAWS
    zf = np.abs(freq - probs) / np.sqrt(probs * (1 - probs) / OPS_DRAWS)
    perm = mt.nd.random.shuffle(mt.nd.array(
        np.arange(OPS_DRAWS, dtype=np.float32), ctx=ctx)).asnumpy()
    is_perm = bool(np.array_equal(np.sort(perm), np.arange(OPS_DRAWS)))
    samp["multinomial"] = dict(freq=freq.tolist(), z=zf.tolist())
    samp["shuffle_is_permutation"] = is_perm
    if not (zf.max() <= OPS_SE and is_perm):
        fails.append(f"multinomial z {zf} / shuffle {is_perm}")
    rows["sampling"] = dict(draws=OPS_DRAWS, se=OPS_SE, **samp)

    from mxnet_tpu_torch.ops import registry
    upd = {}
    for name, arrays, attrs in optimizer_cases(np.random.default_rng(
            SEED + 83)):
        res = []
        for dev in (cuda, cpu):
            ins = [torch.from_numpy(a).to(dev) for a in arrays]
            if name.startswith("mp_"):      # a bf16 weight and gradient
                ins[0], ins[1] = ins[0].bfloat16(), ins[1].bfloat16()
            out = registry.get(name)(*ins, **attrs)
            out = list(out) if isinstance(out, (tuple, list)) else [out]
            res.append([o.double().cpu().numpy() for o in out])
        upd[name] = max(rel_diff(a, b) for a, b in zip(*res))
        if not upd[name] <= OPS_UPDATE_TOL:
            fails.append(f"{name}: card vs CPU {upd[name]}")
    rows["optimizer_ops"] = dict(shape=[4096, 4096], diff=upd,
                                 tol=OPS_UPDATE_TOL)

    x, lab = ctc_inputs(np.random.default_rng(SEED + 84))
    (gl, gg), (cl, cg) = (ctc_run(torch, mt, x, lab, d) for d in (cuda, cpu))
    rl, rg = ctc_run(torch, mt, x.astype(np.float64), lab, cpu)
    ctc = dict(shape=list(x.shape), loss_rel_diff=rel_diff(gl, rl),
               grad_rel_diff=rel_diff(gg, rg),
               cpu_loss_rel_diff=rel_diff(cl, rl),
               cpu_grad_rel_diff=rel_diff(cg, rg),
               card_vs_cpu=max(rel_diff(gl, cl), rel_diff(gg, cg)),
               rtol=OPS_CTC_RTOL, loss_range=[float(rl.min()),
                                              float(rl.max())])
    if not (max(ctc["loss_rel_diff"], ctc["grad_rel_diff"]) <= OPS_CTC_RTOL
            and np.isfinite(gl).all()):
        fails.append(f"CTC: {ctc}")
    rows["ctc"] = ctc

    before, after, secs = custom_softmax_run(mt, mt.gpu(0),
                                             OPS_CUSTOM_EPOCHS)
    rows["custom"] = dict(example="numpy_ops/custom_softmax.py",
                          epochs=OPS_CUSTOM_EPOCHS, acc_before=before,
                          acc_after=after, margin=OPS_CUSTOM_MARGIN,
                          seconds=secs)
    if not after - before >= OPS_CUSTOM_MARGIN:
        fails.append(f"custom: accuracy {before} -> {after}")
    counts = read_counts(mt)
    if any(counts.values()):
        fails.append(f"kernel launches {counts} (want none)")
    emit("ops_c1b2", launches=counts, failures=fails, **rows)
    if fails:
        raise RuntimeError("ops_c1b2: " + "; ".join(fails))


# ---------------------------------------------------------------------------
# C8: the front end (every optimizer, metric, initializer and iterator,
# fixed parameters and reshape in Module, SequentialModule, FeedForward)
# ---------------------------------------------------------------------------
# bench.py:367's BENCH_OPT=lars recipe (its lr, momentum and wd; LARS's
# own eta)
LARS_OPT = {"learning_rate": 0.1, "momentum": 0.9, "wd": 1e-4,
            "eta": 0.001}
LARS_HOST_BATCHES = 4          # seeded host batches, cycled by ResizeIter
LARS_STEPS = 16                # the fit's batches (one epoch)
LARS_WARMUP = 4                # left out of the step statistics
LARS_EVAL_BATCH = 64
# the loss drop (mean of the first 4 steps' losses minus the last 4's),
# from tests/torch_numerics.py c8 (see PERF.md §6)
LARS_MARGIN = 0.05
# the batch-64 eval against the batch-256 rows (max abs difference over
# the largest probability): the CPU, one algorithm for both batches,
# reads 1.4e-5 (tests/torch_numerics.py c8); the card, whose cuDNN takes
# another bf16 convolution algorithm at each batch, read 0.0116 in the
# first whole run of this phase (PERF.md §6, f2); the budget is 2.6 times
# that, and the rows of the next images (the control) must lie beyond it.
# The argmax is printed, not held: a near-tie of the barely trained head
# moved in one row of 64 at a 0.014 difference (f3), and whatever the
# argmax can catch the budget catches, as a flip needs a top-two gap
# within twice the difference
LARS_EVAL_RTOL = 0.03
# examples/image_classification/fine_tune.py's recipe at the north
# star's width: a 100-class head on the last flatten, SGD lr 0.01
# momentum 0.9, Xavier gaussian "in" magnitude 2 for the head
FT_CLASSES = 100
FT_OPT = {"learning_rate": 0.01, "momentum": 0.9}
FT_STEPS = 16
FT_WARMUP = 4
FT_MARGIN = 0.05
# every optimizer name of the JAX package's registry, with the
# hyperparameters of its update
FE_OPTIMIZERS = {
    "sgd": {"learning_rate": 0.1, "momentum": 0.9, "wd": 1e-4},
    "ccsgd": {"learning_rate": 0.1, "momentum": 0.9, "wd": 1e-4},
    "nag": {"learning_rate": 0.1, "momentum": 0.9, "wd": 1e-4},
    "sgld": {"learning_rate": 1e-4, "wd": 1e-4},
    "dcasgd": {"learning_rate": 0.1, "momentum": 0.9, "wd": 1e-4},
    "adam": {"learning_rate": 1e-3, "wd": 1e-4},
    "adagrad": {"learning_rate": 0.01, "wd": 1e-4},
    "rmsprop": {"learning_rate": 1e-3, "centered": True, "wd": 1e-4},
    "adadelta": {"wd": 1e-4},
    "ftrl": {"learning_rate": 0.1},
    "adamax": {"learning_rate": 2e-3, "wd": 1e-4},
    "nadam": {"learning_rate": 1e-3, "wd": 1e-4},
    "signum": {"learning_rate": 1e-3, "wd_lh": 1e-4},
    "lars": dict(LARS_OPT),
    "lamb": {"learning_rate": 1e-3, "wd": 1e-4},
    "test": {},
}
FE_STEPS = 3
FE_TIMED = 5
# card against CPU, per array: ||card - cpu|| / ||cpu - w0||, at most
# FE_BUDGET_FACTOR times the worst fp32-against-float64 distance of the
# same update on the CPU (tests/torch_numerics.py c8 prints it), and at
# least FE_BUDGET_FLOOR
FE_BUDGET_FACTOR = 4.0
FE_BUDGET_FLOOR = 1e-6
# (fp32, bf16 multi-precision) worst distance against float64 per
# optimizer: tests/torch_numerics.py c8's optimizer_budgets
FE_REHEARSED = {
    "sgd": (1.2e-06, 1.9e-06),
    "ccsgd": (1.2e-06, 1.9e-06),
    "nag": (5.9e-07, 7.5e-07),
    "dcasgd": (8.8e-07, 1.8e-06),
    "adam": (1.9e-06, 3.1e-06),
    "adagrad": (3.0e-07, 2.3e-07),
    "rmsprop": (2.7e-07, 3.1e-07),
    "adadelta": (4.3e-07, 5.3e-07),
    "ftrl": (3.4e-09, 2.8e-09),
    "adamax": (9.8e-07, 9.2e-07),
    "nadam": (3.2e-06, 2.7e-06),
    "signum": (2.6e-06, 2.7e-02),
    "lars": (1.3e-04, 1.4e-04),
    "lamb": (1.2e-04, 8.9e-05),
    "test": (6.9e-07, 1.4e-08),
}
# an update that is lr times a sign: one rounding of the momentum
# across zero flips a whole step, so no distance from float64 bounds
# it (signum's bf16 multi-precision row above is such flips).  Card
# and CPU run the same elementwise fp32 ops on the same inputs and
# agree bit for bit (PERF.md §6, PR 14), so these are held to the floor
FE_SIGN_UPDATES = ("signum",)
FE_METRIC_RTOL = 1e-6
FE_ORTHO_TOL = 1e-5
FE_SEQ_RTOL = 1e-5
MNIST_SHAPE = (60000, 28, 28)


def host_batches(batch, image_shape, classes, n, seed):
    """``n`` batches of seeded host data in one pair of arrays: images
    uniform in [-1, 1), float32 labels in [0, classes)."""
    rng = np.random.default_rng(seed)
    x = rng.random((n * batch,) + tuple(image_shape), dtype=np.float32)
    x = x * 2 - 1
    y = rng.integers(0, classes, n * batch).astype(np.float32)
    return x, y


def prefetch_feed(mt, ctx, x, y, batch, steps):
    """``steps`` batches of the host arrays, cycled, staged in pinned
    memory and copied to ``ctx`` on a side stream by a worker thread."""
    base = mt.io.NDArrayIter(x, y, batch_size=batch)
    return mt.io.PrefetchingIter(mt.io.ResizeIter(base, steps),
                                 device_put=True, device=ctx)


class StepClock:
    """A batch-end callback: the ms between batch ends, each ended by
    ``sync`` (the consumer's stream only, so the prefetch copy of the
    next batch is not waited for), and each batch's mean cross-entropy
    from the module's softmax output."""

    def __init__(self, sync):
        self.sync, self.t, self.ms, self.losses = sync, None, [], []

    def __call__(self, param):
        self.sync()
        now = time.monotonic()
        if self.t is not None:
            self.ms.append((now - self.t) * 1e3)
        self.t = now
        mod, batch = param.locals["self"], param.locals["data_batch"]
        prob = mod.get_outputs()[0]._data.float()
        lab = batch.label[0]._data.to(prob.device).long()
        self.losses.append(float(-prob.gather(1, lab[:, None])
                                 .clamp_min(1e-12).log().mean()))


def prefetch_waits(feed):
    """The consumer's waits for the prefetch worker: the first (which
    includes staging and copying the first batch) and the rest's median
    and largest, in ms."""
    w = feed.waits_ms
    rest = w[1:] or [0.0]
    return dict(prefetch_first_wait_ms=w[0] if w else None,
                prefetch_wait_ms_median=float(np.median(rest)),
                prefetch_wait_ms_max=float(max(rest)),
                prefetch_waits=len(w))


def step_stats(ms, warmup):
    timed = ms[max(0, warmup - 1):]
    return dict(median_step_ms=float(np.median(timed)),
                min_step_ms=float(min(timed)), max_step_ms=float(max(timed)),
                steps_timed=len(timed))


def no_sync_update(torch, mod):
    """Run ``mod.update`` under ``set_sync_debug_mode("error")``: a
    wait of the host for the card inside the update raises."""
    real = mod.update

    def update():
        torch.cuda.set_sync_debug_mode("error")
        try:
            real()
        finally:
            torch.cuda.set_sync_debug_mode(0)
    mod.update = update


def lars_fit(mt, ctx, batch, image_shape, steps, sync, update_hook):
    """bench.py's ResNet-50 v2 (bf16 over fp32 masters) trained by
    ``Module.fit`` with LARS over a PrefetchingIter(ResizeIter(
    NDArrayIter)) of seeded host batches, a TopKAccuracy(5) +
    CrossEntropy metric and a ProgressBar; ``update_hook(module)`` runs
    before the fit (the card wraps ``update`` in the sync debug mode,
    the CPU rehearsal leaves it); returns (module, clock, feed, host x,
    host y)."""
    sym = mt.models.get_symbol("resnet", **dict(
        RESNET, image_shape=",".join(str(d) for d in image_shape)))
    x, y = host_batches(batch, image_shape, 1000, LARS_HOST_BATCHES,
                        SEED + 90)
    feed = prefetch_feed(mt, ctx, x, y, batch, steps)
    mod = mt.mod.Module(sym, context=ctx, compute_dtype="bfloat16")
    update_hook(mod)
    clock = StepClock(sync)
    metric = mt.metric.CompositeEvalMetric(
        [mt.metric.TopKAccuracy(5), mt.metric.CrossEntropy()])
    mt.random.seed(SEED + 91)
    mod.fit(feed, eval_metric=metric,
            batch_end_callback=[mt.callback.ProgressBar(steps), clock],
            optimizer="lars", optimizer_params=LARS_OPT,
            initializer=mt.initializer.Xavier(rnd_type="gaussian",
                                              magnitude=2.0),
            num_epoch=1)
    return mod, clock, feed, x, y, metric


def eval_rows(mt, mod, x, n):
    """The softmax output of an inference forward over the first ``n``
    host rows (the module's bound batch must be ``n``)."""
    ctx = mod._context
    mod.forward(mt.io.DataBatch([mt.nd.array(x[:n], ctx=ctx)], None),
                is_train=False)
    return mod.get_outputs()[0]._data.float().clone()


def lars_reshape_checks(torch, mt, mod, x, y, batch, eval_batch):
    """Module.reshape to ``eval_batch``, score a validation iterator
    there, hold the eval outputs against the bound batch's first rows,
    check the parameters' storage and reshape back; one more update
    must continue the momentum (fc1_bias: ``mom' = 0.9 mom - lr g``)."""
    shape = tuple(x.shape[1:])
    rows = eval_rows(mt, mod, x, batch)
    full = rows[:eval_batch]
    params = mod.get_params()[0]
    ptrs = {n: a._data.data_ptr() for n, a in params.items()}
    states = {n: tuple(s for s in st) for n, st in
              mod._updater.states.items()}
    mod.reshape([("data", (eval_batch,) + shape)],
                [("softmax_label", (eval_batch,))])
    small = eval_rows(mt, mod, x, eval_batch)
    rel = float((small - full).abs().max() / full.abs().max())
    pick, top = small.argmax(1), full.argmax(1)
    agree = float((pick == top).float().mean())
    # where the argmax moved: the batch-256 row's gap between its top
    # class and the one batch 64 picked, over the largest probability
    # (a near-tie of a barely trained 1000-class head)
    flips = (pick != top).nonzero().flatten()
    gaps = ((full[flips, top[flips]] - full[flips, pick[flips]])
            / full.abs().max()).tolist()
    # the control: the same distance to the rows of the next images,
    # which a reshape that fed the wrong rows would give
    shifted = rows[1:eval_batch + 1]
    control = float((small - shifted).abs().max() / shifted.abs().max())
    control_agree = float((pick == shifted.argmax(1)).float().mean())
    del rows
    val = mt.io.NDArrayIter(x[:batch], y[:batch], batch_size=eval_batch)
    score = dict(mod.score(val, mt.metric.CompositeEvalMetric(
        [mt.metric.TopKAccuracy(5), mt.metric.CrossEntropy()]),
        score_end_callback=mt.callback.LogValidationMetricsCallback()))
    after = mod.get_params()[0]
    same_storage = all(after[n] is params[n]
                       and after[n]._data.data_ptr() == p
                       for n, p in ptrs.items())
    same_states = all(mod._updater.states[n][i] is s
                      for n, st in states.items() for i, s in enumerate(st))
    mod.reshape([("data", (batch,) + shape)],
                [("softmax_label", (batch,))])
    mom = mod._updater.states["fc1_bias"][0]._data.clone()
    ctx = mod._context
    b = mt.io.DataBatch([mt.nd.array(x[batch:2 * batch], ctx=ctx)],
                        [mt.nd.array(y[batch:2 * batch], ctx=ctx)])
    mod.forward(b, is_train=True)
    mod.backward()
    mod.update()
    g = mod._exec.grad_dict["fc1_bias"]._data * (1.0 / batch)
    want = LARS_OPT["momentum"] * mom - LARS_OPT["learning_rate"] * g
    got = mod._updater.states["fc1_bias"][0]._data
    mom_err = float((got - want).abs().max() / want.abs().max())
    return dict(eval_rel_diff=rel, eval_argmax_agree=agree,
                eval_argmax_flip_gaps=gaps, eval_control_rel_diff=control,
                eval_control_argmax_agree=control_agree,
                val_score=score, same_storage=same_storage,
                same_states=same_states, momentum_rel_err=mom_err,
                momentum_was_zero=bool(float(mom.abs().max()) == 0.0))


def phase_resnet_lars_fit(torch, mt, peak_flops, prefix):
    """ResNet-50 v2 at full width trained with LARS by Module.fit from a
    prefetching iterator, the update under the sync debug mode, then
    reshape / score / reshape back; saves the module's checkpoint at
    ``prefix`` (epoch 1) and returns the phase's row."""
    dev = torch.device("cuda", 0)
    B, shape = RESNET_BATCH, (3, 224, 224)
    torch.cuda.reset_peak_memory_stats()
    reset_counts(mt)
    t0 = time.monotonic()
    mod, clock, feed, x, y, metric = lars_fit(
        mt, mt.gpu(0), B, shape, LARS_STEPS,
        torch.cuda.current_stream(dev).synchronize,
        lambda m: no_sync_update(torch, m))
    fit_s = time.monotonic() - t0
    counts = read_counts(mt)
    dispatch = mt.profiler.dispatch_counts()
    peak = torch.cuda.max_memory_allocated()
    feed.close()
    del mod.update          # the class's own update from here on
    fails = []
    stats = step_stats(clock.ms, LARS_WARMUP)
    med = stats["median_step_ms"]
    flops = 2 * RESNET_FWD_MACS * 3 * B
    tflops = flops / (med / 1e3) / 1e12
    first, last = float(np.mean(clock.losses[:4])), \
        float(np.mean(clock.losses[-4:]))
    if dispatch.get("module.update") != LARS_STEPS or any(counts.values()):
        fails.append(f"dispatches {dispatch}, launches {counts} (want "
                     f"{LARS_STEPS} updates, no kernel)")
    if not all(np.isfinite(clock.losses)) or \
            not last < first - LARS_MARGIN:
        fails.append(f"losses {clock.losses}: the last 4's mean does not "
                     f"beat the first 4's by {LARS_MARGIN}")
    b0 = mt.io.DataBatch([mt.nd.array(x[:B], ctx=mt.gpu(0))],
                         [mt.nd.array(y[:B], ctx=mt.gpu(0))])
    _, busy, _ = profiled_step(torch, mod, b0)
    idle = max(0.0, 1 - busy / med)
    checks = lars_reshape_checks(torch, mt, mod, x, y, B, LARS_EVAL_BATCH)
    if not checks["eval_rel_diff"] <= LARS_EVAL_RTOL:
        fails.append(f"batch-{LARS_EVAL_BATCH} eval differs from the "
                     f"batch-{B} rows by {checks['eval_rel_diff']}")
    if not checks["eval_control_rel_diff"] > LARS_EVAL_RTOL:
        fails.append(f"the next images' rows are within "
                     f"{checks['eval_control_rel_diff']} of the batch-"
                     f"{LARS_EVAL_BATCH} eval: the {LARS_EVAL_RTOL} budget "
                     "cannot tell rows apart")
    if not (checks["same_storage"] and checks["same_states"]):
        fails.append("reshape moved a parameter or an optimizer state")
    if checks["momentum_was_zero"] or not checks["momentum_rel_err"] \
            <= 1e-5:
        fails.append(f"momentum after reshaping back: {checks}")
    row = dict(model="resnet-50 v2", batch=B, image=list(shape),
               classes=1000, compute_dtype="bfloat16", masters="float32",
               optimizer="lars lr 0.1 momentum 0.9 wd 1e-4 eta 0.001",
               feed="PrefetchingIter(ResizeIter(NDArrayIter(4 host "
                    "batches)), device_put=True)",
               fit_s=fit_s, steps=LARS_STEPS, **stats,
               step_ms=clock.ms, images_per_s=B / (med / 1e3),
               flops_per_step=flops, achieved_tflops=tflops,
               mfu=tflops * 1e12 / peak_flops, peak_mem_bytes=peak,
               device_busy_ms=busy, device_idle_share=idle,
               **prefetch_waits(feed), losses=clock.losses,
               loss_first4_mean=first, loss_last4_mean=last,
               margin=LARS_MARGIN, train_metric=dict(zip(*metric.get())),
               update_sync_debug_mode="error", dispatches=dispatch,
               attention_launches=counts, eval_rtol=LARS_EVAL_RTOL,
               failures=fails, **checks)
    emit("resnet_lars_fit", **row)
    if fails:
        raise RuntimeError("resnet_lars_fit: " + "; ".join(fails))
    mod.save_checkpoint(prefix, 1)
    return row


def finetune_symbol(mt, sym, classes):
    """fine_tune.py's get_fine_tune_model: the last flatten output, a new
    ``fc_finetune`` head and a SoftmaxOutput."""
    internals = sym.get_internals()
    outputs = [o for o in internals.list_outputs()
               if "flatten" in o and o.endswith("_output")]
    net = mt.sym.FullyConnected(data=internals[outputs[-1]],
                                num_hidden=classes, name="fc_finetune")
    return mt.sym.SoftmaxOutput(data=net, name="softmax")


def finetune_fit(mt, ctx, prefix, epoch, batch, image_shape, steps, sync):
    """fine_tune.py's second stage: the checkpoint cut at its last
    flatten, every trunk argument fixed, the head fitted; returns
    (module, clock, feed, trunk names, args, aux)."""
    sym, args, aux = mt.model.load_checkpoint(prefix, epoch)
    net = finetune_symbol(mt, sym, FT_CLASSES)
    trunk = [n for n in net.list_arguments()
             if n not in ("data", "softmax_label")
             and not n.startswith("fc_finetune")]
    args = {k: v for k, v in args.items() if k in set(trunk)}
    x, y = host_batches(batch, image_shape, FT_CLASSES, LARS_HOST_BATCHES,
                        SEED + 92)
    feed = prefetch_feed(mt, ctx, x, y, batch, steps)
    mod = mt.mod.Module(net, context=ctx, compute_dtype="bfloat16",
                        fixed_param_names=trunk)
    clock = StepClock(sync)
    mt.random.seed(SEED + 93)
    mod.fit(feed, eval_metric="acc", batch_end_callback=clock,
            arg_params=args, aux_params=aux, allow_missing=True,
            optimizer="sgd", optimizer_params=FT_OPT,
            initializer=mt.initializer.Xavier(rnd_type="gaussian",
                                              factor_type="in",
                                              magnitude=2),
            num_epoch=1)
    return mod, clock, feed, trunk, args, aux


def phase_resnet_finetune(torch, mt, prefix, lars_row):
    """The LARS module's checkpoint fine-tuned with a frozen trunk by
    Module.fit: fixed parameters bit-identical and without gradients,
    the head changed, the loss down by FT_MARGIN."""
    import gc
    dev = torch.device("cuda", 0)
    B, shape = RESNET_BATCH, (3, 224, 224)
    gc.collect()
    torch.cuda.empty_cache()
    torch.cuda.reset_peak_memory_stats()
    reset_counts(mt)
    t0 = time.monotonic()
    mod, clock, feed, trunk, args, aux = finetune_fit(
        mt, mt.gpu(0), prefix, 1, B, shape, FT_STEPS,
        torch.cuda.current_stream(dev).synchronize)
    fit_s = time.monotonic() - t0
    counts = read_counts(mt)
    dispatch = mt.profiler.dispatch_counts()
    peak = torch.cuda.max_memory_allocated()
    feed.close()
    fails = []
    got, aux_now = mod.get_params()
    changed = [n for n in trunk if not torch.equal(
        got[n]._data.cpu(), args[n]._data.cpu())]
    grads = [n for n in trunk if mod._exec.grad_dict[n] is not None
             or got[n]._data.requires_grad]
    head0 = mod._exec.arg_dict["fc_finetune_weight"]
    moved_aux = sum(not torch.equal(aux_now[n]._data.cpu(), aux[n]._data)
                    for n in aux)
    stats = step_stats(clock.ms, FT_WARMUP)
    first, last = float(np.mean(clock.losses[:4])), \
        float(np.mean(clock.losses[-4:]))
    if changed or grads:
        fails.append(f"fixed parameters changed {changed[:5]} or have "
                     f"gradients {grads[:5]}")
    if not all(np.isfinite(clock.losses)) or \
            not last < first - FT_MARGIN:
        fails.append(f"losses {clock.losses}: the last 4's mean does not "
                     f"beat the first 4's by {FT_MARGIN}")
    if dispatch.get("module.update") != FT_STEPS or any(counts.values()):
        fails.append(f"dispatches {dispatch}, launches {counts}")
    emit("resnet_finetune", model="resnet-50 v2 trunk + fc_finetune",
         batch=B, classes=FT_CLASSES, compute_dtype="bfloat16",
         masters="float32", optimizer="sgd lr 0.01 momentum 0.9",
         fixed_params=len(trunk), head_weight_shape=list(head0.shape),
         fit_s=fit_s, steps=FT_STEPS, **stats, step_ms=clock.ms,
         images_per_s=B / (stats["median_step_ms"] / 1e3),
         peak_mem_bytes=peak, lars_peak_mem_bytes=lars_row["peak_mem_bytes"],
         lars_median_step_ms=lars_row["median_step_ms"],
         **prefetch_waits(feed), losses=clock.losses,
         loss_first4_mean=first, loss_last4_mean=last,
         margin=FT_MARGIN, fixed_changed=len(changed),
         fixed_with_grad=len(grads), aux_states_moved=int(moved_aux),
         aux_states=len(aux), dispatches=dispatch,
         attention_launches=counts, failures=fails)
    if fails:
        raise RuntimeError("resnet_finetune: " + "; ".join(fails))


def resnet_param_shapes(mt):
    sym = mt.models.get_symbol("resnet", **RESNET)
    shapes = sym.infer_shape(data=(1, 3, 224, 224))[0]
    return [(n, tuple(s)) for n, s in zip(sym.list_arguments(), shapes)
            if n not in ("data", "softmax_label")]


def opt_inputs(shapes, seed, steps):
    """Seeded host weights and ``steps`` gradients per array."""
    rng = np.random.default_rng(seed)
    w = {n: rng.standard_normal(s, dtype=np.float32) * 0.05
         for n, s in shapes}
    g = [{n: rng.standard_normal(s, dtype=np.float32) * 0.01
          for n, s in shapes} for _ in range(steps)]
    return w, g


def opt_run(mt, name, w, grads, ctx, dtype=None, multi_precision=False):
    """``len(grads)`` updates of every array by one updater keyed by
    parameter name; returns the updated weights (their fp32 masters
    with multi-precision) as CPU tensors, and the updater."""
    import torch
    params = dict(FE_OPTIMIZERS[name], multi_precision=multi_precision)
    opt = mt.optimizer.create(name, param_idx2name={n: n for n in w},
                              **params)
    upd = mt.optimizer.get_updater(opt)
    dt = dtype or "float32"
    weights = {n: mt.nd.array(v, ctx=ctx, dtype=dt) for n, v in w.items()}
    for g in grads:
        for n, v in g.items():
            upd(n, mt.nd.array(v, ctx=ctx, dtype=dt), weights[n])
    if multi_precision:
        return {n: upd.states[n][0]._data.cpu() for n in w}, upd
    return {n: a._data.cpu() for n, a in weights.items()}, upd


def bf16_rounded(d):
    """float32 arrays rounded to bfloat16 and back (nearest even)."""
    import torch
    return {k: torch.from_numpy(v).bfloat16().float().numpy()
            for k, v in d.items()}


def opt_distance(torch, a, b, w0):
    """Per array, ||a - b|| / ||b - w0|| (float64)."""
    out = {}
    for n, x in a.items():
        x, y = x.double(), b[n].double()
        ref = (y - torch.from_numpy(w0[n]).double()).norm()
        out[n] = float((x - y).norm() / max(float(ref), 1e-30))
    return out


def opt_time(torch, mt, name, w, grad):
    """Median ms of FE_TIMED whole-set updates on the card (CUDA
    events), and the bytes they must move: each weight, gradient and
    state read once and each weight and state written once."""
    ctx = mt.gpu(0)
    opt = mt.optimizer.create(name, param_idx2name={n: n for n in w},
                              **FE_OPTIMIZERS[name])
    upd = mt.optimizer.get_updater(opt)
    weights = {n: mt.nd.array(v, ctx=ctx) for n, v in w.items()}
    grads = {n: mt.nd.array(v, ctx=ctx) for n, v in grad.items()}
    for n in w:
        upd(n, grads[n], weights[n])
    ms = []
    for _ in range(FE_TIMED):
        s, e = torch.cuda.Event(enable_timing=True), \
            torch.cuda.Event(enable_timing=True)
        s.record()
        for n in w:
            upd(n, grads[n], weights[n])
        e.record()
        torch.cuda.synchronize()
        ms.append(s.elapsed_time(e))
    n_states = sum(st is not None for st in upd.states[next(iter(w))])
    nbytes = sum(a.size for a in w.values()) * 4 * (3 + 2 * n_states)
    return float(np.median(ms)), nbytes


def sgld_noise_check(torch, mt, w, g):
    """SGLD on the card: its step minus the deterministic part is
    N(0, sqrt(lr)); (mean, std, expected std, standard error)."""
    lr, wd = FE_OPTIMIZERS["sgld"]["learning_rate"], \
        FE_OPTIMIZERS["sgld"]["wd"]
    got, _ = opt_run(mt, "sgld", w, [g], mt.gpu(0))
    noise = []
    for n, x in got.items():
        wd_n = wd if n.endswith(("_weight", "_gamma")) else 0.0
        det = w[n].astype(np.float64) - lr / 2 * (g[n] + wd_n * w[n])
        noise.append((x.double().numpy() - det).ravel())
    noise = np.concatenate(noise)
    return dict(mean=float(noise.mean()), std=float(noise.std()),
                want_std=float(np.sqrt(lr)),
                se=float(np.sqrt(lr) / np.sqrt(noise.size)),
                n=int(noise.size))


def fe_optimizers(torch, mt):
    """Every optimizer on ResNet-50's parameter shapes: FE_STEPS updates
    on the card and on the CPU in fp32, again with bf16 weights under
    multi_precision (the fp32 masters compared), each array within its
    budget; SGLD by its deterministic part and its noise's moments; the
    whole set's update time beside its bytes bound."""
    shapes = resnet_param_shapes(mt)
    w, grads = opt_inputs(shapes, SEED + 94, FE_STEPS)
    rows, fails = {}, []
    for name in FE_OPTIMIZERS:
        if name == "sgld":
            s = sgld_noise_check(torch, mt, w, grads[0])
            ok = abs(s["mean"]) < 5 * s["se"] and \
                abs(s["std"] - s["want_std"]) < 5 * s["want_std"] / \
                np.sqrt(2 * s["n"])
            rows[name] = dict(noise=s)
            if not ok:
                fails.append(f"sgld noise {s}")
        else:
            row = {}
            for mp in (False, True):
                dt = "bfloat16" if mp else None
                card, _ = opt_run(mt, name, w, grads, mt.gpu(0), dt, mp)
                # the fp32 masters from bf16 weights and gradients are an
                # fp32 run from the bf16-rounded ones, on the CPU
                wc, gc = (bf16_rounded(w), [bf16_rounded(g) for g in grads]) \
                    if mp else (w, grads)
                cpu, _ = opt_run(mt, name, wc, gc, mt.cpu())
                worst = max(opt_distance(torch, card, cpu, wc).values())
                budget = FE_BUDGET_FLOOR if name in FE_SIGN_UPDATES else \
                    max(FE_BUDGET_FLOOR,
                        FE_BUDGET_FACTOR * FE_REHEARSED[name][int(mp)])
                row["mp_bf16" if mp else "fp32"] = dict(
                    worst_rel_dist=worst, budget=budget)
                if not worst <= budget:
                    fails.append(f"{name} ({'bf16 mp' if mp else 'fp32'}): "
                                 f"card vs CPU {worst} > {budget}")
                del card, cpu
            rows[name] = row
        ms, nbytes = opt_time(torch, mt, name, w, grads[0])
        rows[name].update(update_ms=ms, bytes=nbytes,
                          bound_ms=nbytes / PEAK_BYTES_PER_S * 1e3,
                          bound_by="bytes")
        torch.cuda.empty_cache()
    return dict(arrays=len(shapes),
                parameters=int(sum(np.prod(s) for _, s in shapes)),
                steps=FE_STEPS, **rows), fails


def fe_metrics(torch, mt):
    """Every new metric updated from card tensors against the same
    metric from CPU tensors."""
    rng = np.random.default_rng(SEED + 95)
    prob = rng.random((256, 1000), dtype=np.float32) + 1e-3
    prob /= prob.sum(1, keepdims=True)
    lab = rng.integers(0, 1000, 256).astype(np.float32)
    bin_p = rng.random((256, 2), dtype=np.float32)
    bin_l = rng.integers(0, 2, 256).astype(np.float32)
    reg_p = rng.standard_normal((256, 3)).astype(np.float32)
    reg_l = rng.standard_normal((256, 3)).astype(np.float32)
    cases = {"f1": (bin_l, bin_p), "mae": (reg_l, reg_p),
             "mse": (reg_l, reg_p), "rmse": (reg_l, reg_p),
             "nll_loss": (lab, prob),
             "pearsonr": (reg_l[:, 0], reg_p[:, 0]),
             "torch": (lab, prob[:, 0]), "caffe": (lab, prob[:, 0])}
    out, fails = {}, []
    for name, (l, p) in cases.items():
        vals = []
        for ctx in (mt.gpu(0), mt.cpu()):
            m = mt.metric.create(name)
            for _ in range(2):
                m.update([mt.nd.array(l, ctx=ctx)], [mt.nd.array(p, ctx=ctx)])
            vals.append(m.get()[1])
        out[name] = dict(card=vals[0], cpu=vals[1])
        if not abs(vals[0] - vals[1]) <= FE_METRIC_RTOL * abs(vals[1]):
            fails.append(f"metric {name}: {vals}")
    m = mt.metric.np(lambda label, pred: float(np.abs(label - pred).mean()))
    m.update([mt.nd.array(reg_l, ctx=mt.gpu(0))],
             [mt.nd.array(reg_p, ctx=mt.gpu(0))])
    want = float(np.abs(reg_l - reg_p).mean())
    out["custom_np"] = dict(card=m.get()[1], numpy=want)
    if not abs(m.get()[1] - want) <= FE_METRIC_RTOL * want:
        fails.append(f"metric.np: {m.get()[1]} vs {want}")
    return out, fails


def fe_initializers(torch, mt, workdir):
    """The initializers on the card against the CPU from the same seed
    (every draw is made on the CPU, so equal bit for bit), and
    Orthogonal's orthogonality."""
    path = os.path.join(workdir, "init.params")
    mt.nd.save(path, {"arg:w_weight": mt.nd.array(
        np.arange(12, dtype=np.float32).reshape(3, 4), ctx=mt.cpu())})
    inits = {
        "orthogonal": (mt.initializer.Orthogonal, (256, 2304)),
        "msraprelu": (mt.initializer.MSRAPrelu, (256, 64, 3, 3)),
        "bilinear": (mt.initializer.Bilinear, (64, 1, 4, 4)),
        "load": (lambda: mt.initializer.Load(path), (3, 4)),
        "mixed": (lambda: mt.initializer.Mixed(
            [".*"], [mt.initializer.Xavier()]), (128, 256))}
    out, fails = {}, []
    for name, (make, shape) in inits.items():
        vals = []
        for ctx in (mt.gpu(0), mt.cpu()):
            arr = mt.nd.zeros(shape, ctx=ctx)
            mt.random.seed(SEED + 96)
            make()(mt.initializer.InitDesc("w_weight"), arr)
            vals.append(arr._data.cpu())
        same = bool(torch.equal(vals[0], vals[1]))
        out[name] = dict(shape=list(shape), card_equals_cpu=same)
        if not same:
            fails.append(f"initializer {name}: card differs from the CPU")
    q = out["orthogonal"]
    arr = mt.nd.zeros((256, 2304), ctx=mt.gpu(0))
    mt.initializer.Orthogonal(scale=1.0)(mt.initializer.InitDesc("q_weight"),
                                         arr)
    a = arr._data.double()
    q["orthogonality_err"] = float((a @ a.T - torch.eye(
        256, dtype=torch.float64, device=a.device)).abs().max())
    if not q["orthogonality_err"] <= FE_ORTHO_TOL:
        fails.append(f"orthogonal: {q['orthogonality_err']}")
    return out, fails


def write_idx(path, arr):
    """An IDX file (MNIST's container) of a uint8 array."""
    import struct
    with open(path, "wb") as f:
        f.write(struct.pack(">HBB", 0, 0x08, arr.ndim))
        f.write(struct.pack(">" + "I" * arr.ndim, *arr.shape))
        f.write(arr.tobytes())


def fe_iterators(torch, mt, workdir):
    """CSVIter, LibSVMIter and MNISTIter (60000 x 28 x 28 idx files
    written here from a seed) yield the files' contents, read again
    through a PrefetchingIter onto the card."""
    rng = np.random.default_rng(SEED + 97)
    out, fails = {}, []
    imgs = rng.integers(0, 256, MNIST_SHAPE, dtype=np.uint8)
    labs = rng.integers(0, 10, MNIST_SHAPE[0], dtype=np.uint8)
    ip = os.path.join(workdir, "train-images-idx3-ubyte")
    lp = os.path.join(workdir, "train-labels-idx1-ubyte")
    write_idx(ip, imgs)
    write_idx(lp, labs)
    t0 = time.monotonic()
    it = mt.io.MNISTIter(image=ip, label=lp, batch_size=1000, shuffle=False,
                         silent=True)
    feed = mt.io.PrefetchingIter(it, device_put=True, device=mt.gpu(0))
    xs, ys, devices = [], [], set()
    for b in feed:
        devices.add(b.data[0]._data.device.type)
        xs.append(b.data[0]._data.cpu())
        ys.append(b.label[0]._data.cpu())
    feed.close()
    if devices != {"cuda"}:
        fails.append(f"MNIST batches on {devices}, not on the card")
    x = torch.cat(xs).numpy()
    ok = x.shape == (MNIST_SHAPE[0], 1, 28, 28) and np.array_equal(
        x[:, 0], imgs.astype(np.float32) / 255.0) and np.array_equal(
        torch.cat(ys).numpy(), labs.astype(np.float32))
    out["mnist"] = dict(images=MNIST_SHAPE[0], batches=len(xs), equal=ok,
                        seconds=time.monotonic() - t0)
    if not ok:
        fails.append("MNISTIter batches differ from the idx files")
    data = rng.random((1000, 12), dtype=np.float32)
    label = np.arange(1000, dtype=np.float32)
    dp, lbp = os.path.join(workdir, "d.csv"), os.path.join(workdir, "l.csv")
    np.savetxt(dp, data, delimiter=",")
    np.savetxt(lbp, label, delimiter=",")
    it = mt.io.CSVIter(data_csv=dp, data_shape=(3, 4), label_csv=lbp,
                       batch_size=100, round_batch=False)
    got = np.concatenate([b.data[0].asnumpy() for b in it])
    want = np.loadtxt(dp, delimiter=",", dtype=np.float32)
    ok = np.array_equal(got.reshape(1000, 12), want)
    out["csv"] = dict(rows=1000, equal=ok)
    if not ok:
        fails.append("CSVIter batches differ from the file")
    dense = np.zeros((500, 300), np.float32)
    lines = []
    for i in range(500):
        cols = np.sort(rng.choice(300, rng.integers(1, 20), replace=False))
        vals = np.round(rng.uniform(-2, 2, cols.size), 4).astype(np.float32)
        dense[i, cols] = vals
        lines.append("%d %s" % (i % 2, " ".join(
            "%d:%s" % (c, repr(float(v))) for c, v in zip(cols, vals))))
    sp = os.path.join(workdir, "d.libsvm")
    with open(sp, "w") as f:
        f.write("\n".join(lines) + "\n")
    it = mt.io.LibSVMIter(data_libsvm=sp, data_shape=(300,), batch_size=50)
    got = np.concatenate([b.data[0].asnumpy() for b in it])
    ok = np.array_equal(got, dense)
    out["libsvm"] = dict(rows=500, equal=ok)
    if not ok:
        fails.append("LibSVMIter batches differ from the file")
    return out, fails


def fe_feedforward(mt, ctx):
    """matrix_fact.py through FeedForward at module_heads' sizes, epochs
    and optimizer: (validation RMSE before, after)."""
    import warnings
    u, i, r = mf_ratings(SEED + 72)
    nt = int(0.9 * len(r))
    np.random.seed(SEED + 73)
    train = mt.io.NDArrayIter({"user": u[:nt], "item": i[:nt]},
                              {"score": r[:nt]}, batch_size=256,
                              shuffle=True, last_batch_handle="discard")

    def rmse(model):
        ev = mt.io.NDArrayIter({"user": u[nt:], "item": i[nt:]},
                               batch_size=256)
        out = model.predict(ev).reshape(-1)
        return float(np.sqrt(((out - r[nt:][:len(out)]) ** 2).mean()))
    def model(epochs, arg_params=None):
        return mt.model.FeedForward(
            mf_sym(mt), ctx=ctx, num_epoch=epochs, optimizer="adam",
            initializer=mt.initializer.Normal(0.3), learning_rate=0.02,
            arg_params=arg_params)
    mt.random.seed(SEED + 74)
    with warnings.catch_warnings():
        warnings.simplefilter("ignore", DeprecationWarning)
        init = model(0).fit(train)      # the initial parameters only
        train.reset()
        trained = model(HEADS_EPOCHS["matrix_fact"],
                        init.arg_params).fit(train)
    return rmse(init), rmse(trained)


def fe_sequential(torch, mt):
    """A SequentialModule of two Modules against one Module over the
    whole graph, one SGD step each from the same parameters on the
    card (fp32): the largest parameter difference, relative."""
    rng = np.random.default_rng(SEED + 98)
    x = rng.standard_normal((256, 512)).astype(np.float32)
    y = rng.integers(0, 10, 256).astype(np.float32)
    S = mt.sym
    trunk = S.Activation(S.FullyConnected(S.Variable("data"),
                                          num_hidden=1024, name="fc1"),
                         act_type="relu")
    head = S.FullyConnected(S.Variable("data"), num_hidden=10, name="fc2")
    whole = S.SoftmaxOutput(S.FullyConnected(trunk, num_hidden=10,
                                             name="fc2"), name="softmax")
    args = {"fc1_weight": rng.standard_normal((1024, 512)) * 0.03,
            "fc1_bias": np.zeros(1024), "fc2_weight":
            rng.standard_normal((10, 1024)) * 0.03, "fc2_bias": np.zeros(10)}
    args = {k: v.astype(np.float32) for k, v in args.items()}
    ctx = mt.gpu(0)
    opt = {"learning_rate": 0.1, "momentum": 0.9, "wd": 1e-4}
    seq = mt.mod.SequentialModule()
    seq.add(mt.mod.Module(trunk, label_names=None, context=ctx))
    seq.add(mt.mod.Module(S.SoftmaxOutput(head, name="softmax"),
                          context=ctx), take_labels=True)
    one = mt.mod.Module(whole, context=ctx)
    batch = mt.io.DataBatch([mt.nd.array(x, ctx=ctx)],
                            [mt.nd.array(y, ctx=ctx)])
    for m in (seq, one):
        m.bind(data_shapes=[("data", (256, 512))],
               label_shapes=[("softmax_label", (256,))])
        m.init_params(arg_params=args, aux_params={})
        m.init_optimizer(optimizer="sgd", optimizer_params=opt)
        for _ in range(2):
            m.forward(batch, is_train=True)
            m.backward()
            m.update()
    a, b = seq.get_params()[0], one.get_params()[0]
    return max(float((a[k]._data - b[k]._data).abs().max()
                     / b[k]._data.abs().max()) for k in b)


def phase_front_end(torch, mt):
    """Small checks of the front end on the card: every optimizer, the
    new metrics, initializers and file iterators, FeedForward and
    SequentialModule; no kernel launches."""
    reset_counts(mt)
    fails = []
    t0 = time.monotonic()
    rows = {}
    rows["optimizers"], f = fe_optimizers(torch, mt)
    fails += f
    rows["optimizers_s"] = time.monotonic() - t0
    rows["metrics"], f = fe_metrics(torch, mt)
    fails += f
    with tempfile.TemporaryDirectory() as workdir:
        rows["initializers"], f = fe_initializers(torch, mt, workdir)
        fails += f
        rows["iterators"], f = fe_iterators(torch, mt, workdir)
        fails += f
    before, after = fe_feedforward(mt, mt.gpu(0))
    rows["feedforward"] = dict(example="recommender/matrix_fact.py",
                               val_rmse_before=before, val_rmse_after=after,
                               margin=HEADS_MARGIN["matrix_fact"])
    if not before - after > HEADS_MARGIN["matrix_fact"]:
        fails.append(f"FeedForward RMSE {before} -> {after}")
    diff = fe_sequential(torch, mt)
    rows["sequential"] = dict(rel_diff=diff, rtol=FE_SEQ_RTOL)
    if not diff <= FE_SEQ_RTOL:
        fails.append(f"SequentialModule differs from the Module by {diff}")
    counts = read_counts(mt)
    if any(counts.values()):
        fails.append(f"kernel launches {counts} (want none)")
    emit("front_end", seconds=time.monotonic() - t0, launches=counts,
         failures=fails, **rows)
    if fails:
        raise RuntimeError("front_end: " + "; ".join(fails))


# ---------------------------------------------------------------------------
# C3: data IO on the card (record files, nvJPEG, I1)
# ---------------------------------------------------------------------------
# the JPEG record file: ImageNet's usual training sizes (h, w), its 1000
# classes, quality 95; each image a smooth field (a random 6 x 8 grid
# upsampled) plus luma and weaker chroma noise of a seeded strength, so
# that the mean record lands in REC_KB_RANGE (ImageNet's training JPEGs
# average about 110 KB; PIL's q95 encoder gives 82.8-128.9 KB, mean
# 107.8, over the noise range on this generator: tests/torch_numerics.py
# c3)
REC_IMAGES = 1024
REC_SIZES = ((375, 500), (500, 375))
REC_QUALITY = 95
REC_CLASSES = 1000
REC_NOISE = (6.0, 20.0)
REC_KB_RANGE = (80.0, 150.0)
# nvJPEG's decode against PIL's on the same records: the JAX package's own
# bound for its native decoder against PIL (tests/test_io_image.py:100),
# mean absolute levels (the two decoders' IDCT and chroma upsampling
# differ)
DECODE_MAD_TOL = 2.0
# examples/image_classification/train_imagenet.py:71-76
IMAGENET_REC_ARGS = dict(data_shape=(3, 224, 224), batch_size=256,
                         shuffle=True, rand_mirror=True, rand_crop=True,
                         resize=256, mean_r=123.68, mean_g=116.779,
                         mean_b=103.939)
REC_WARMUP, REC_STEPS = 3, 10
REC_WINDOW = 8              # profiled steps fed by the iterator
# train_imagenet.py:57-69: raw records packed at 256 x 256
# (tools/im2rec.py --pack-raw 256), two epochs of them
UINT8_REC_ARGS = dict(data_shape=(3, 224, 224), batch_size=256,
                      shuffle=True, rand_mirror=True, rand_crop=True,
                      part_index=0, num_parts=1)
UINT8_IMAGES, UINT8_STORED = 512, 256
UINT8_WARMUP, UINT8_STEPS = 3, 3
# train_ssd.py:63-65 over a record file of 96 images (three batches of
# 32) with 1-4 boxes each; 2 + 4 steps (two epochs)
SSD_REC_IMAGES = 96
SSD_REC_WARMUP, SSD_REC_STEPS = 2, 4
SSD_REC_CROP = 0.5          # the crop sampler's share in the label check
# the pixels normalized to about unit scale, as ssd_train's synthetic
# batches (0-1) are: from raw 0-255 values SSD-VGG16's losses diverged
# within six steps on the card (the means of IMAGENET_REC_ARGS, the stds
# of mxnet_tpu/image/image.py CreateAugmenter)
SSD_REC_NORM = dict(mean_r=123.68, mean_g=116.779, mean_b=103.939,
                    std_r=58.395, std_g=57.12, std_b=57.375)
REC_DATASET_IMAGES = 256
REC_DATASET_BATCH = 64
I1_SOURCE = os.path.join("mxnet_tpu_torch", "csrc", "image_augment.cu")
I1_DESIGN = (
    "a block per (band of 8 output rows, image), 128 threads: the image's "
    "table read once a thread, no division to find a pixel; the column "
    "taps (both byte offsets and the weight, mirror applied) once a block "
    "and the row taps once a row, in shared memory; the band's source "
    "window staged into shared memory by 16-byte loads (each row aligned "
    "down, its offset carried); four output x a thread, one float4 (or "
    "32-bit) store a channel plane, a scalar tail for ragged widths; bytes "
    "to floats and back by the 2^23 bias (no conversion instructions); "
    "the identity a staged crop-and-mirror copy; every float operation "
    "__f*_rn in the host code's order, bit-identical to the plain version")
# a crop whose width is not a multiple of 4 (scalar stores): 299 x 299 of
# the record file's images resized to 320, batch 32
I1_RAGGED = dict(batch=32, resize=320, crop=(299, 299))


def i1_count():
    from mxnet_tpu_torch.ops import image_augment
    return image_augment.augment_cuda.launches


def reset_i1(mt):
    from mxnet_tpu_torch.ops import image_augment
    image_augment.augment_cuda.launches = 0


def rec_image(torch, dev, gen, h, w, sigma):
    """One (h, w, 3) uint8 image on the card: a smooth field plus luma
    noise of ``sigma`` levels and chroma noise of 0.3 sigma."""
    import torch.nn.functional as F
    low = torch.randn((1, 3, 6, 8), generator=gen, device=dev) * 50
    field = F.interpolate(low, size=(h, w), mode="bilinear",
                          align_corners=False)[0].permute(1, 2, 0) + 128
    lum = torch.randn((h, w, 1), generator=gen, device=dev) * sigma
    chroma = torch.randn((h, w, 3), generator=gen, device=dev) * (0.3 * sigma)
    return (field + lum + chroma).clamp(0, 255).to(torch.uint8).contiguous()


def rec_specs(n, seed):
    """Each image's (h, w), noise and label, drawn on the host."""
    rng = np.random.default_rng(seed)
    sizes = [REC_SIZES[k] for k in rng.integers(0, 2, n)]
    return sizes, rng.uniform(*REC_NOISE, n), \
        rng.integers(0, REC_CLASSES, n).astype(np.float32)


def rec_jpegs(mt, path, start, n):
    """The JPEG payloads and labels of records ``start`` .. ``start + n``
    of an indexed record file."""
    from mxnet_tpu_torch import native
    offs = native.index_rec_file(path)
    raws = native.read_records(path, offs[start:start + n])
    heads = [mt.recordio.unpack(r) for r in raws]
    return [p for _, p in heads], np.array([h.label for h, _ in heads],
                                           np.float32)


def stop_producer(it):
    """Stop a record iterator's producer thread, as its ``reset()`` does
    before starting the next epoch's, and wait for it: no batch (and no
    I1 launch) of it falls into a later count."""
    import queue
    it._stop.set()
    try:
        while it._queue.get_nowait() is not None:
            pass
    except queue.Empty:
        pass
    it._worker.join(timeout=60)
    if it._worker.is_alive():
        raise RuntimeError("a record iterator's producer did not stop")


def count_batches(it):
    """A box whose [0] counts the batches the iterator's producer makes
    from here on."""
    real, box = it._produce, [0]

    def produce(idxs):
        out = real(idxs)
        box[0] += 1
        return out
    it._produce = produce
    return box


def decoder_row(dec):
    from mxnet_tpu_torch.image import nvjpeg
    return dict(decoder=f"nvjpeg {nvjpeg.version()}",
                hardware_backend=dec.hardware, hw_status=dec.hw_status,
                hw_engines=dec.hw_engines, hw_cores_per_engine=dec.hw_cores,
                backend_counts=dict(dec.backend_counts),
                decode_failures=dec.failures)


def decoder_probe():
    """What the machine offers the data path: nvJPEG's header and library
    in the CUDA toolkit, libjpeg's header (the host decoder's), PIL."""
    import glob
    import PIL
    home = os.environ.get("CUDA_HOME", "/usr/local/cuda")
    return dict(cuda_home=home,
                nvjpeg_h=os.path.exists(os.path.join(home, "include",
                                                     "nvjpeg.h")),
                libnvjpeg=sorted(os.path.basename(f) for f in glob.glob(
                    os.path.join(home, "lib*", "libnvjpeg.so*"))),
                jpeglib_h=os.path.exists("/usr/include/jpeglib.h"),
                pil=PIL.__version__)


def nvjpeg_vs_pil_by_size(torch, mt, dev):
    """nvJPEG's decode against PIL's by image size: at each size one
    image of each kind (a smooth 4 x 4 field plus 30 levels of uniform
    per-channel noise, and ``rec_image`` at 12 levels), encoded by the
    card at REC_QUALITY, decoded by both; mean absolute levels."""
    import io as _io
    import torch.nn.functional as F
    from PIL import Image
    from mxnet_tpu_torch.image import nvjpeg
    dec = nvjpeg.Decoder(dev)
    gen = torch.Generator(device=dev).manual_seed(SEED + 101)

    def distance(img):
        jpg = mt.recordio.unpack(mt.recordio.pack_img(
            (0, 0.0, 0, 0), img, quality=REC_QUALITY))[1]
        images, fails = dec.decode([jpg], 3)
        if fails:
            raise RuntimeError("nvjpeg_vs_pil_by_size: a failed decode")
        got = images.image(0).float().cpu().numpy()
        pil = np.asarray(Image.open(_io.BytesIO(jpg)).convert("RGB"),
                         np.float32)
        return float(np.abs(got - pil).mean())

    out = []
    for h, w in ((51, 46), (64, 80), (375, 500)):
        base = torch.rand((1, 3, 4, 4), generator=gen, device=dev) * 200
        field = F.interpolate(base, size=(h, w), mode="bilinear")[0]
        noise = torch.rand((3, h, w), generator=gen, device=dev) * 30
        uniform = (field + noise).clamp(0, 255).to(torch.uint8) \
            .permute(1, 2, 0).contiguous()
        out.append(dict(size=[h, w], uniform_noise=distance(uniform),
                        rec_image=distance(rec_image(torch, dev, gen, h, w,
                                                     12.0))))
    dec.close()
    return out


def phase_rec_write(torch, mt, workdir):
    """REC_IMAGES seeded images made on the card, encoded there by nvJPEG
    through ``recordio.pack_img`` and written with an index: mean record
    size, encode rate; the first batch's records decoded by nvJPEG, held
    against the source pixels (printed) and against PIL's decode of the
    same bytes (DECODE_MAD_TOL); the decode rate of one batch alone; the
    machine's JPEG libraries, and nvJPEG against PIL by image size."""
    import io as _io
    from PIL import Image
    from mxnet_tpu_torch import native
    from mxnet_tpu_torch.image import nvjpeg
    dev = torch.device("cuda", 0)
    gen = torch.Generator(device=dev).manual_seed(SEED + 100)
    sizes, sigmas, labels = rec_specs(REC_IMAGES, SEED + 100)
    path = os.path.join(workdir, "imagenet.rec")
    rec = mt.recordio.MXIndexedRecordIO(path[:-4] + ".idx", path, "w")
    B = IMAGENET_REC_ARGS["batch_size"]
    src, nbytes, enc_s = [], [], 0.0
    t0 = time.monotonic()
    for i in range(REC_IMAGES):
        img = rec_image(torch, dev, gen, *sizes[i], sigmas[i])
        torch.cuda.synchronize()
        t = time.monotonic()
        payload = mt.recordio.pack_img((0, float(labels[i]), i, 0), img,
                                       quality=REC_QUALITY)
        enc_s += time.monotonic() - t
        rec.write_idx(i, payload)
        nbytes.append(len(payload))
        if i < B:
            src.append(img)
    rec.close()
    write_s = time.monotonic() - t0
    jpegs, labs = rec_jpegs(mt, path, 0, B)
    dec = nvjpeg.Decoder(dev)
    images, fails = dec.decode(jpegs, 3)
    torch.cuda.synchronize()
    mad_src, mad_pil, worst_pil = [], [], 0.0
    for i in range(B):
        got = images.image(i).float()
        mad_src.append(float((got - src[i].float()).abs().mean()))
        pil = np.asarray(Image.open(_io.BytesIO(bytes(jpegs[i])))
                         .convert("RGB"))
        d = float((got.cpu() - torch.from_numpy(pil.astype(np.float32)))
                  .abs().mean())
        mad_pil.append(d)
        worst_pil = max(worst_pil, d)
    # one batch's decode alone (after the one above warmed it), synchronised
    t = time.monotonic()
    dec.decode(jpegs, 3)
    torch.cuda.synchronize()
    decode_ms = (time.monotonic() - t) * 1e3
    kb = np.array(nbytes) / 1024
    row = dict(records=REC_IMAGES, sizes=[list(s) for s in REC_SIZES],
               quality=REC_QUALITY, classes=REC_CLASSES,
               noise_levels=list(REC_NOISE), file_bytes=os.path.getsize(path),
               mean_record_kb=float(kb.mean()), min_record_kb=float(kb.min()),
               max_record_kb=float(kb.max()), kb_range=list(REC_KB_RANGE),
               encoder="nvjpeg (recordio.pack_img of a CUDA tensor), "
                       "baseline 4:2:0",
               encode_s=enc_s, encode_images_per_s=REC_IMAGES / enc_s,
               encode_mb_per_s=sum(nbytes) / enc_s / 1e6, write_s=write_s,
               checked=B, labels_equal=bool(np.array_equal(labs,
                                                           labels[:B])),
               mad_vs_source_mean=float(np.mean(mad_src)),
               mad_vs_source_max=float(np.max(mad_src)),
               mad_vs_pil_mean=float(np.mean(mad_pil)),
               mad_vs_pil_max=worst_pil, mad_vs_pil_tol=DECODE_MAD_TOL,
               decode_batch_ms=decode_ms,
               decode_images_per_s=B / (decode_ms / 1e3),
               host_jpeg_library=native.available("jpeg_io"),
               probe=decoder_probe(),
               mad_vs_pil_by_size=nvjpeg_vs_pil_by_size(torch, mt, dev),
               **decoder_row(dec))
    fails_ = []
    if fails or not row["labels_equal"]:
        fails_.append(f"{fails} failed decodes, labels equal "
                      f"{row['labels_equal']}")
    if not REC_KB_RANGE[0] <= row["mean_record_kb"] <= REC_KB_RANGE[1]:
        fails_.append(f"mean record {row['mean_record_kb']} KB")
    if not worst_pil < DECODE_MAD_TOL:
        fails_.append(f"nvJPEG's decode {worst_pil} levels from PIL's")
    row["failures"] = fails_
    emit("rec_write", **row)
    if fails_:
        raise RuntimeError("rec_write: " + "; ".join(fails_))
    dec.close()
    return path, row


def phase_i1_kernel(torch, mt, path):
    """I1 against its plain version bit for bit at the main path's shape
    (batch 256 of the record file's images decoded by nvJPEG, resized to
    256 x 256, cropped to 224 at the iterator's draws, mirrored,
    normalized by the example's means), with a failed slot too, at a
    width that is not a multiple of 4 (``I1_RAGGED``), and its uint8
    instances (NCHW and NHWC, 224 crops of 256 x 256 raw images); each
    relaunched and required identical; times by CUDA events (the whole
    call), the kernel's device time by torch.profiler and the wrapper's
    host time, beside the bytes bound and the previous design's time."""
    from mxnet_tpu_torch.image import nvjpeg
    from mxnet_tpu_torch.ops import image_augment as ia
    dev = torch.device("cuda", 0)
    B = IMAGENET_REC_ARGS["batch_size"]
    c, h, w = IMAGENET_REC_ARGS["data_shape"]
    R = IMAGENET_REC_ARGS["resize"]
    jpegs, _ = rec_jpegs(mt, path, 0, B)
    dec = nvjpeg.Decoder(dev)
    images, _ = dec.decode(jpegs, 3)
    rng = np.random.RandomState(SEED + 101)
    y0 = rng.randint(0, R - h + 1, B)
    x0 = rng.randint(0, R - w + 1, B)
    flips = rng.rand(B) < 0.5
    mean = np.array([IMAGENET_REC_ARGS[k] for k in ("mean_r", "mean_g",
                                                    "mean_b")], np.float32)
    std = np.ones(3, np.float32)
    args = (y0, x0, flips, (R, R), (h, w), mean, std)
    rows, fails = {}, []

    def check(name, imgs, a, out="float32", layout="NCHW"):
        got = ia.augment_cuda(imgs, *a, out=out, layout=layout)
        again = ia.augment_cuda(imgs, *a, out=out, layout=layout)
        want = ia.augment_plain(imgs, *a, out=out, layout=layout)
        torch.cuda.synchronize()
        err = float((got.float() - want.float()).abs().max())
        same = bool(torch.equal(got, want)) and bool(torch.equal(got, again))
        if not same:
            fails.append(f"{name}: kernel differs from the plain version "
                         f"by {err} (or from its relaunch)")
        row = dict(shape=list(got.shape), out=out, layout=layout,
                   bit_identical=same, max_abs_err=err)

        def call():
            return ia.augment_cuda(imgs, *a, out=out, layout=layout)
        timed(row, "kernel_ms", call, iters=20, repeats=5)
        # the kernel alone and the wrapper's host time a call: the row's
        # kernel_ms is the larger of the two where the host cannot keep
        # ahead.  The kernel alone is timed by events over back-to-back
        # launches of its C entry with the table staged once (no host
        # work between launches)
        kern = i1_kernel_only(torch, ia, imgs, a, out, layout, got)
        row["device_ms"] = time_ms(kern, iters=20, repeats=5)[0]
        row["device_ms_by"] = ("CUDA events over 20 back-to-back launches "
                               "of the kernel alone, median of 5")
        row["host_ms"] = host_ms(torch, call)
        timed(row, "plain_ms", lambda: ia.augment_plain(
            imgs, *a, out=out, layout=layout), iters=1, repeats=3, warmup=1)
        nbytes = ia.bound_bytes(imgs, a[0], a[1], a[2], a[3], a[4],
                                4 if out == "float32" else 1)
        row.update(bound_bytes=nbytes,
                   bound_ms=nbytes / PEAK_BYTES_PER_S * 1e3,
                   bound_by="bytes", library_ms=None,
                   library="none: no one PyTorch call resizes, crops, "
                           "mirrors and normalizes ragged images")
        check_bound_share(row, "device_ms", fails, f"i1 {name}")
        rows[name] = row

    check("main", images, args)
    # a failed decode in slot 5: its pixels read as zeros
    failed = ia.DecodedImages(images.flat, images.offsets, images.heights,
                              images.widths, 3,
                              np.arange(B) != 5)
    check("failed_slot", failed, args)
    # a width that is not a multiple of 4: the scalar stores
    rb, rr, (rh, rw) = (I1_RAGGED[k] for k in ("batch", "resize", "crop"))
    ragged = ia.DecodedImages(images.flat, images.offsets[:rb],
                              images.heights[:rb], images.widths[:rb], 3)
    check("ragged_299", ragged, (rng.randint(0, rr - rh + 1, rb),
                                 rng.randint(0, rr - rw + 1, rb),
                                 rng.rand(rb) < 0.5, (rr, rr), (rh, rw),
                                 mean, std))
    # the uint8 instances: raw 256 x 256 images (random bytes) made on the
    # card, cropped and mirrored
    gen = torch.Generator(device=dev).manual_seed(SEED + 102)
    S = UINT8_STORED
    raw = torch.randint(0, 256, (B * S * S * 3,), generator=gen,
                        device=dev, dtype=torch.uint8)
    rawi = ia.DecodedImages(raw, np.arange(B) * (S * S * 3),
                            np.full(B, S), np.full(B, S), 3)
    uargs = (y0, x0, flips, (S, S), (h, w), None, None)
    check("uint8_nchw", rawi, uargs, "uint8", "NCHW")
    check("uint8_nhwc", rawi, uargs, "uint8", "NHWC")
    emit("i1_kernel", source=I1_SOURCE, design=I1_DESIGN, cases=rows,
         failures=fails)
    dec.close()
    if fails:
        raise RuntimeError("i1_kernel: " + "; ".join(fails))
    return rows


def i1_kernel_only(torch, ia, imgs, a, out, layout, want):
    """A call that launches I1 alone through its C entry on the current
    stream, its table (``ia._meta``) staged on the card once; checked
    once against ``want`` (the wrapper's output), bit for bit."""
    y0s, x0s, flips, dec_hw, out_hw, mean, std = a
    dev = want.device
    meta = torch.from_numpy(ia._meta(imgs, y0s, x0s, flips, mean,
                                     std)).to(dev)
    res = torch.empty_like(want)
    n, c = len(imgs), imgs.channels
    call = c_entry_launch(torch, "image_augment.cu", "mxtt_image_augment", (
        meta.data_ptr(), res.data_ptr(), n, c, dec_hw[0], dec_hw[1],
        out_hw[0], out_hw[1], ia.OUT_KINDS[(out, layout)], dev.index or 0),
        dev)
    call()
    torch.cuda.synchronize()
    if not torch.equal(res, want):
        raise RuntimeError("I1 launched alone differs from its wrapper")
    return call


def c_entry_launch(torch, lib, entry, args, dev):
    """A call that launches a kernel through its C entry ``entry`` of
    ``cuda_lib.library(lib)`` on the current stream, with ``args`` (device
    pointers and sizes staged once) before the stream: no allocation and
    no host work between launches, so CUDA events over back-to-back
    calls time the kernel alone.  The wrapper must have run once (it
    sets the entry's argument types)."""
    from mxnet_tpu_torch import cuda_lib
    fn = getattr(cuda_lib.library(lib), entry)

    def call():
        err = fn(*args, torch.cuda.current_stream(dev).cuda_stream)
        if err:
            raise RuntimeError(f"{entry} returned {err}")
    return call


def profiled_window(torch, fn, n):
    """``n`` calls of ``fn`` under torch.profiler, ended by a
    synchronise: (window ms, the card's busy ms, its largest kernels)."""
    torch.cuda.synchronize()
    with device_window(torch) as prof:
        t = time.monotonic()
        for _ in range(n):
            fn()
        torch.cuda.synchronize()
        ms = (time.monotonic() - t) * 1e3
    kernels = device_kernels(prof)
    busy = sum(k[0] for k in kernels)
    if busy <= 0:
        raise RuntimeError("profile: no device time in the window")
    return ms, busy, kernels


def rec_fit(torch, mt, it, steps, warmup, sym=None):
    """ResNet-50 v2 (bf16 over fp32 masters, SGD momentum) trained by
    ``Module.fit`` over ``steps`` batches of the record iterator ``it``
    (ResizeIter without resetting it: it restarts itself at its end),
    counts reset just before and read just after; returns (module, row,
    failures)."""
    dev = torch.device("cuda", 0)
    sym = sym or mt.models.get_symbol("resnet", **RESNET)
    # the epoch its constructor started is stopped and a new one started
    # after the counts are reset, so that every batch made is counted
    stop_producer(it)
    made = count_batches(it)
    torch.cuda.reset_peak_memory_stats()
    reset_counts(mt)
    reset_i1(mt)
    reset_r1()
    it.reset()
    waits0 = len(it.wait_ms)
    feed = mt.io.ResizeIter(it, steps, reset_internal=False)
    mod = mt.mod.Module(sym, context=mt.gpu(0), compute_dtype="bfloat16")
    clock = StepClock(torch.cuda.current_stream(dev).synchronize)
    mt.random.seed(SEED + 103)
    t0 = time.monotonic()
    mod.fit(feed, eval_metric=mt.metric.CrossEntropy(),
            batch_end_callback=[clock], optimizer="sgd",
            optimizer_params=RESNET_OPT,
            initializer=mt.initializer.Xavier(rnd_type="gaussian",
                                              magnitude=2.0),
            num_epoch=1)
    fit_s = time.monotonic() - t0
    stop_producer(it)
    launches, batches = i1_count(), made[0]
    counts = read_counts(mt)
    r1 = r1_count()
    dispatch = mt.profiler.dispatch_counts()
    peak = torch.cuda.max_memory_allocated()
    waits = it.wait_ms[waits0:]
    stats = step_stats(clock.ms, warmup)
    fails = []
    if launches != batches or batches < steps:
        fails.append(f"I1 launched {launches} times for {batches} batches "
                     f"made ({steps} steps): want once a batch")
    if r1 != steps * relu_nodes(sym):
        fails.append(f"R1 launched {r1} times over {steps} steps of "
                     f"{relu_nodes(sym)} relus")
    if any(counts.values()) or dispatch.get("module.update") != steps:
        fails.append(f"launches {counts} (want none), dispatches "
                     f"{dispatch} (want {steps} updates)")
    if not all(np.isfinite(clock.losses)):
        fails.append(f"non-finite loss in {clock.losses}")
    timed_waits = waits[warmup:] or [0.0]
    row = dict(model="resnet-50 v2", compute_dtype="bfloat16",
               masters="float32", optimizer="sgd lr 0.1 momentum 0.9 wd "
               "1e-4", fit_s=fit_s, steps=steps, **stats,
               step_ms=clock.ms,
               images_per_s=it.batch_size / (stats["median_step_ms"] / 1e3),
               wait_ms_per_step_median=float(np.median(timed_waits)),
               wait_ms_per_step_max=float(max(timed_waits)),
               wait_first_ms=waits[0] if waits else None, waits=len(waits),
               i1_launches=launches, relu_grad_launches=r1,
               batches_made=batches,
               epochs_of_the_file=batches * it.batch_size /
               len(it._offsets),
               decode_failures=it.decode_failures, peak_mem_bytes=peak,
               losses=clock.losses, dispatches=dispatch,
               attention_launches=counts)
    return mod, row, fails


def pipeline_rate(torch, it, n):
    """Images a second through the iterator alone: ``n`` batches, each
    synchronised, after one batch of warm-up (restarting at the end)."""
    def one():
        try:
            b = it.next()
        except StopIteration:
            it.reset()
            b = it.next()
        b.data[0]._data.sum()
        torch.cuda.synchronize()
    one()
    t = time.monotonic()
    for _ in range(n):
        one()
    return n * it.batch_size / (time.monotonic() - t)


def phase_imagenet_rec_fit(torch, mt, path, synthetic_ms, peak_flops):
    """The slice's main path: train_imagenet.py's ImageRecordIter over
    the JPEG record file (nvJPEG + I1 on the card) feeding ResNet-50 v2
    at batch 256 through Module.fit, REC_WARMUP + REC_STEPS steps over
    more than one epoch of the file; step ms beside resnet_train's
    synthetic step of this run, the iterator's wait a step, the
    pipeline's images a second alone, the card's idle share over steps
    fed by the iterator."""
    B = IMAGENET_REC_ARGS["batch_size"]
    probe = mt.io.ImageRecordIter(path_imgrec=path, seed=SEED + 104,
                                  **IMAGENET_REC_ARGS)
    rate = pipeline_rate(torch, probe, 3)
    stop_producer(probe)
    it = mt.io.ImageRecordIter(path_imgrec=path, **IMAGENET_REC_ARGS)
    steps = REC_WARMUP + REC_STEPS
    mod, row, fails = rec_fit(torch, mt, it, steps, REC_WARMUP)
    # the card's idle share over REC_WINDOW steps fed by the iterator, its
    # producer decoding the next batches meanwhile (the file holds four
    # batches, so the window spans two epochs' starts, as the fit does)
    it.reset()
    feed = mt.io.ResizeIter(it, REC_WINDOW + 1, reset_internal=False)

    def step():
        b = feed.next()
        mod.forward(b, is_train=True)
        mod.update()
    step()
    win_ms, busy, kernels = profiled_window(torch, step, REC_WINDOW)
    stop_producer(it)
    med = row["median_step_ms"]
    flops = 2 * RESNET_FWD_MACS * 3 * B
    out = mod.get_outputs()[0]
    if tuple(out.shape) != (B, 1000) or \
            not bool(torch.isfinite(out._data.float()).all()):
        fails.append(f"output {tuple(out.shape)} not finite")
    i1 = [k for k in kernels if "image_augment" in k[2]]
    row.update(args=IMAGENET_REC_ARGS, records=len(it._offsets),
               pipeline_images_per_s=rate,
               synthetic_median_step_ms=synthetic_ms,
               step_over_synthetic=med / synthetic_ms,
               achieved_tflops=flops / (med / 1e3) / 1e12,
               mfu=flops / (med / 1e3) / peak_flops,
               profiled_steps=REC_WINDOW, profiled_window_ms=win_ms,
               device_busy_ms=busy,
               device_idle_share=max(0.0, 1 - busy / win_ms),
               i1_ms_in_window=sum(k[0] for k in i1),
               top_kernels=[dict(ms=ms, count=c, name=k)
                            for ms, c, k in kernels[:10]],
               **decoder_row(it.decoder), failures=fails)
    emit("imagenet_rec_fit", **row)
    if fails:
        raise RuntimeError("imagenet_rec_fit: " + "; ".join(fails))
    del mod
    it.decoder.close()
    torch.cuda.empty_cache()
    return row


def phase_uint8_rec_fit(torch, mt, path, workdir):
    """train_imagenet.py's --uint8-rec path: the JPEG records decoded by
    nvJPEG and resized to 256 x 256 by I1 (uint8 NHWC, no crop), packed
    raw as tools/im2rec.py --pack-raw 256 packs them, then
    ImageRecordUInt8Iter (I1 crops and mirrors on the card) feeding the
    same ResNet-50 v2 for UINT8_WARMUP + UINT8_STEPS steps."""
    from mxnet_tpu_torch.image import nvjpeg
    from mxnet_tpu_torch.ops import image_augment as ia
    dev = torch.device("cuda", 0)
    S = UINT8_STORED
    raw_path = os.path.join(workdir, "imagenet_raw.rec")
    rec = mt.recordio.MXIndexedRecordIO(raw_path[:-4] + ".idx", raw_path, "w")
    dec = nvjpeg.Decoder(dev)
    t0 = time.monotonic()
    step = IMAGENET_REC_ARGS["batch_size"]
    for start in range(0, UINT8_IMAGES, step):
        jpegs, labels = rec_jpegs(mt, path, start % REC_IMAGES, step)
        images, _ = dec.decode(jpegs, 3)
        z = np.zeros(len(jpegs), np.int64)
        raw = ia.augment(images, z, z, z.astype(bool), (S, S), (S, S),
                         out="uint8", layout="NHWC").cpu().numpy()
        for i in range(len(jpegs)):
            rec.write_idx(start + i, mt.recordio.pack(
                (0, float(labels[i]), start + i, 0), raw[i].tobytes()))
    rec.close()
    pack_s = time.monotonic() - t0
    dec.close()
    it = mt.io.ImageRecordUInt8Iter(path_imgrec=raw_path, **UINT8_REC_ARGS)
    steps = UINT8_WARMUP + UINT8_STEPS
    mod, row, fails = rec_fit(torch, mt, it, steps, UINT8_WARMUP)
    row.update(args=UINT8_REC_ARGS, records=UINT8_IMAGES,
               stored_shape=[S, S, 3], pack_s=pack_s,
               file_bytes=os.path.getsize(raw_path), failures=fails)
    emit("uint8_rec_fit", **row)
    if fails:
        raise RuntimeError("uint8_rec_fit: " + "; ".join(fails))
    del mod
    torch.cuda.empty_cache()
    return row


def det_images(torch, dev, n, seed):
    """``n`` (h, w, 3) uint8 images on the card at ImageNet's sizes, each
    the record file's field with 1-4 filled rectangles of the class shade
    0.3 + 0.7 c / (C - 1) (as ssd_batches draws them), and their classes
    and normalized boxes."""
    C = SSD["num_classes"]
    rng = np.random.default_rng(seed)
    gen = torch.Generator(device=dev).manual_seed(seed)
    sizes, sigmas, _ = rec_specs(n, seed)
    images, classes, boxes = [], [], []
    for i in range(n):
        h, w = sizes[i]
        img = rec_image(torch, dev, gen, h, w, sigmas[i]) // 4
        cl, bx = [], []
        for _ in range(int(rng.integers(1, 5))):
            c = int(rng.integers(0, C))
            bh = int(rng.integers(h // 6, h // 2))
            bw = int(rng.integers(w // 6, w // 2))
            y0, x0 = int(rng.integers(0, h - bh)), int(rng.integers(0, w - bw))
            img[y0:y0 + bh, x0:x0 + bw] = int(255 * (0.3 + 0.7 * c / (C - 1)))
            cl.append(float(c))
            bx.append([x0 / w, y0 / h, (x0 + bw) / w, (y0 + bh) / h])
        images.append(img)
        classes.append(cl)
        boxes.append(bx)
    return images, classes, boxes


class LabelsOnly:
    """``native.decode_jpeg_batch`` for a CPU ImageDetRecordIter where
    libjpeg's headers may be missing (a GPU machine need not have them,
    and the card path needs none): zero pixels of the asked shape, so that
    the CPU path's own code computes the labels (crop sampler, mirror)
    while no pixel is compared."""

    def __init__(self, native):
        self.native, self.real = native, native.decode_jpeg_batch

    def __enter__(self):
        def zeros(jpegs, h, w, c=3, nthreads=0):
            return np.zeros((len(jpegs), h, w, c), np.uint8), 0
        self.native.decode_jpeg_batch = zeros
        return self

    def __exit__(self, *a):
        self.native.decode_jpeg_batch = self.real


def phase_ssd_rec_fit(torch, mt, workdir):
    """SSD-VGG16 (as ssd_train: batch 32, 300 x 300, bf16) trained from an
    ImageDetRecordIter over a record file written in pack_det_dataset's
    format by the card's encoder, with train_ssd.py:63-65's arguments,
    SSD_REC_WARMUP + SSD_REC_STEPS steps over two epochs; then the detect
    graph on one batch of it (N1); then the labels of the first two
    batches with the crop sampler on, against the same iterator on the
    CPU (its labels computed by the CPU path's code, its pixels not
    decoded: see LabelsOnly)."""
    from mxnet_tpu_torch import native
    dev = torch.device("cuda", 0)
    B, S = SSD["batch"], SSD["size"]
    path = os.path.join(workdir, "ssd.rec")
    t0 = time.monotonic()
    images, classes, boxes = det_images(torch, dev, SSD_REC_IMAGES,
                                        SEED + 105)
    mt.image.pack_det_dataset(path, images, classes, boxes, quality=95)
    write_s = time.monotonic() - t0
    kw = dict(data_shape=(3, S, S), batch_size=B,
              max_objects=SSD["max_objects"], rand_mirror=True, shuffle=True,
              **SSD_REC_NORM)
    it = mt.io.ImageDetRecordIter(path, **kw)
    mod = ssd_module(mt, mt.gpu(0), "bfloat16")
    stop_producer(it)
    made = count_batches(it)
    reset_counts(mt)
    reset_i1(mt)
    it.reset()
    n = SSD_REC_WARMUP + SSD_REC_STEPS
    feed = mt.io.ResizeIter(it, n, reset_internal=False)
    waits0 = len(it.wait_ms)
    step_ms, stats, last = [], [], None
    for _ in range(n):
        b = feed.next()
        t = time.monotonic()
        mod.forward(b, is_train=True)
        mod.backward()
        mod.update()
        torch.cuda.synchronize()
        step_ms.append((time.monotonic() - t) * 1e3)
        stats.append(ssd_stats(torch, mod.get_outputs()))
        last = b
    stats = torch.stack(stats).cpu().numpy()
    # the detect graph with the trained parameters on the last batch
    params = {k: v for k, v in mod.get_params()[0].items()}
    net = mt.models.ssd_vgg16(num_classes=SSD["num_classes"], mode="detect")
    det = mt.mod.Module(net, context=mt.gpu(0), data_names=("data",),
                        label_names=None, compute_dtype="bfloat16")
    det.bind([mt.io.DataDesc("data", (B, 3, S, S))], for_training=False)
    det.init_params(arg_params={k: v for k, v in params.items()
                                if k in net.list_arguments()})
    det.forward(mt.io.DataBatch([last.data[0]], []), is_train=False)
    dets = det.get_outputs()[0]._data
    torch.cuda.synchronize()
    stop_producer(it)
    launches, batches = i1_count(), made[0]
    counts = read_counts(mt)
    waits = it.wait_ms[waits0:]
    fails = []
    if launches != batches or batches < n:
        fails.append(f"I1 launched {launches} times for {batches} batches")
    if not counts["nms_suppress"] or any(
            v for k, v in counts.items() if k != "nms_suppress"):
        fails.append(f"launches {counts}: want N1 in the detect pass and "
                     "no attention kernel")
    if not np.isfinite(stats[:, :2]).all() or \
            not bool(torch.isfinite(dets.float()).all()):
        fails.append(f"losses {stats[:, :2].tolist()} or detections not "
                     "finite")
    # the crop sampler's labels, card against CPU
    ck = dict(kw, rand_crop=SSD_REC_CROP, seed=SEED + 106)
    card = mt.io.ImageDetRecordIter(path, **ck)
    with LabelsOnly(native):
        cpu = mt.io.ImageDetRecordIter(path, device=mt.cpu(), **ck)
        cpu_labels = [cpu.next().label[0].asnumpy() for _ in range(2)]
        stop_producer(cpu)
    card_labels = [card.next().label[0].asnumpy() for _ in range(2)]
    stop_producer(card)
    labels_equal = all(np.array_equal(a, b)
                       for a, b in zip(card_labels, cpu_labels))
    if not labels_equal:
        fails.append("the card's labels after the crop sampler differ from "
                     "the CPU path's")
    losses = [float(c + l) for c, l in stats[:, :2]]
    emit("ssd_rec_fit", model="ssd_vgg16", **SSD, args=kw,
         records=SSD_REC_IMAGES, write_s=write_s, steps=n,
         step_ms=step_ms, **step_stats(step_ms, SSD_REC_WARMUP),
         losses=losses, wait_ms=waits,
         wait_ms_per_step_median=float(np.median(waits[SSD_REC_WARMUP:]
                                                 or [0.0])),
         i1_launches=launches, batches_made=batches, launches=counts,
         detections=list(dets.shape),
         labels_checked=sum(int((l[..., 0] >= 0).sum())
                            for l in card_labels),
         labels_equal_cpu=labels_equal, crop_sampler=SSD_REC_CROP,
         **decoder_row(it.decoder), failures=fails)
    if fails:
        raise RuntimeError("ssd_rec_fit: " + "; ".join(fails))
    for x in (it, card):
        x.decoder.close()
    del mod, det
    torch.cuda.empty_cache()
    return counts, launches


def phase_rec_dataset(torch, mt, path):
    """gluon.data.vision.ImageRecordDataset over the JPEG record file
    through a DataLoader with worker threads (PIL decodes on the host, as
    in the JAX package), one pass over REC_DATASET_IMAGES records: each
    batch's shape and labels; images a second."""
    ds = mt.gluon.data.vision.ImageRecordDataset(
        path, transform=lambda x, y: (mt.nd.NDArray(
            x.as_torch()[:224, :224], ctx=mt.cpu()), y))
    _, want = rec_jpegs(mt, path, 0, REC_DATASET_IMAGES)
    sampler = mt.gluon.data.BatchSampler(
        mt.gluon.data.SequentialSampler(REC_DATASET_IMAGES),
        REC_DATASET_BATCH, "keep")
    loader = mt.gluon.data.DataLoader(ds, batch_sampler=sampler,
                                      num_workers=4)
    t0 = time.monotonic()
    shapes, labels, devices = [], [], set()
    with mt.gpu(0):
        for x, y in loader:
            shapes.append(tuple(x.shape))
            devices.add(str(x._data.device))
            labels.append(y.asnumpy())
    torch.cuda.synchronize()
    secs = time.monotonic() - t0
    labels = np.concatenate(labels)
    fails = []
    if shapes != [(REC_DATASET_BATCH, 224, 224, 3)] * (
            REC_DATASET_IMAGES // REC_DATASET_BATCH) or \
            not np.array_equal(labels, want) or devices != {"cuda:0"}:
        fails.append(f"batches {shapes} on {devices}, labels equal "
                     f"{np.array_equal(labels, want)}")
    emit("rec_dataset", records=REC_DATASET_IMAGES, batch=REC_DATASET_BATCH,
         workers=4, decoder="PIL (imdecode, host)", seconds=secs,
         images_per_s=REC_DATASET_IMAGES / secs, batch_shapes=shapes[:1],
         devices=sorted(devices), failures=fails)
    if fails:
        raise RuntimeError("rec_dataset: " + "; ".join(fails))


# ---------------------------------------------------------------------------
# C2: sparse storage and the single-process KVStore on the card
# ---------------------------------------------------------------------------
# examples/sparse/linear_classification.py at a user's width: avazu-app's
# LIBSVM width (1,000,000 hashed features, 15 nonzeros a row), batch 8192,
# the example's learning rate; 4 distinct batches of the seeded rows, taken
# in turn, so the loss of a batch seen before falls
SPARSE_FEATURES = 1_000_000
SPARSE_NNZ = 15
SPARSE_BATCH = 8192
SPARSE_BATCHES = 4
SPARSE_LR = 0.5
SPARSE_WARMUP, SPARSE_STEPS = 3, 10
# card against the port's CPU run after the 13 steps: the CPU tests'
# tolerances (tests/test_torch_sparse_paths.py: float32 logs and sigmoids
# an ulp apart, sums in another order; lazy Adam's steps of rows whose
# summed gradient cancels to about its epsilon, 2e-4 absolute).  The
# CPU's float32 run ends within 6.8e-11 (SGD) and 4.4e-5 (Adam) of a
# float64 run's weights (tests/torch_numerics.py c2)
SPARSE_TOL = {"sgd": dict(rtol=1e-5, atol=1e-6),
              "adam": dict(rtol=1e-5, atol=2e-4)}
# csr.dot(w) against csr.todense() @ w on the first CSR_CHECK_ROWS rows of
# a batch (4 GB dense): 15 products a row summed in another order
CSR_CHECK_ROWS = 1024
CSR_DOT_TOL = dict(rtol=1e-5, atol=1e-6)
# examples/recommender/two_tower.py at MovieLens-20M's size (138,493 users,
# 26,744 rated movies), dimension 64, batch 8192, SGD through
# Trainer(kvstore='device'); the example's learning rate 0.5 at its batch
# 64, scaled linearly to 8192 (a row is read about once a batch, so the
# unscaled rate moves it 128 times less); its planted rank-4 affinities
# and top-16 preference pools, computed on the card for the drawn users
TOWER_USERS, TOWER_ITEMS, TOWER_DIM = 138_493, 26_744, 64
TOWER_BATCH, TOWER_BATCHES = 8192, 4
TOWER_LR = 0.5 * 8192 / 64
TOWER_RANK, TOWER_POOL = 4, 16
TOWER_WARMUP, TOWER_STEPS = 3, 10
# card against CPU after the steps: float32 dot products of 64 terms and
# the repeated rows' gradient sums (index_add_'s atomics on the card) in
# another order; the CPU's float32 tables end within 3.0e-7 of a float64
# run's (tests/torch_numerics.py c2), so two float32 runs within 2e-6,
# against tables of order 0.3-1.6
TOWER_TOL = dict(rtol=1e-5, atol=2e-6)
# Module.fit of a small MLP (64 -> 128 -> 10) through a local store
KV_MLP = dict(samples=4096, features=64, hidden=128, classes=10, batch=128,
              epochs=2)


def sparse_dataset(seed):
    """SPARSE_BATCHES x SPARSE_BATCH rows of SPARSE_NNZ distinct columns
    (repeats in a row redrawn), +-1 values and the planted weight's
    sign as the label, as the example's make_dataset makes them (its
    rng.choice without replacement permutes all 10^6 columns a row)."""
    rng = np.random.RandomState(seed)
    n = SPARSE_BATCH * SPARSE_BATCHES
    planted = rng.randn(SPARSE_FEATURES).astype(np.float32)
    cols = np.sort(rng.randint(0, SPARSE_FEATURES, (n, SPARSE_NNZ)), axis=1)
    while True:
        dup = np.zeros(cols.shape, bool)
        dup[:, 1:] = cols[:, 1:] == cols[:, :-1]
        if not dup.any():
            break
        cols[dup] = rng.randint(0, SPARSE_FEATURES, int(dup.sum()))
        cols.sort(axis=1)
    vals = rng.choice([-1.0, 1.0], cols.shape).astype(np.float32)
    y = ((planted[cols] * vals).sum(axis=1) > 0).astype(np.float32)
    return cols, vals, y


def write_libsvm(path, cols, vals, y):
    with open(path, "w") as f:
        for c, v, lab in zip(cols, vals, y):
            f.write("%d %s\n" % (lab, " ".join(
                "%d:%d" % (ci, vi) for ci, vi in zip(c, v))))


class LinearRun:
    """The example's training state on ``ctx``: the local store, the
    weight with a row-sparse gradient, the bias, the optimizer and its
    states."""

    def __init__(self, mt, optimizer, ctx, dtype="float32"):
        self.mt, self.ctx = mt, ctx
        self.kv = mt.kv.create("local")
        self.w = mt.nd.zeros((SPARSE_FEATURES, 1), ctx=ctx, dtype=dtype)
        self.w.attach_grad(stype="row_sparse")
        self.bias = mt.nd.zeros((1,), ctx=ctx, dtype=dtype)
        self.bias.attach_grad()
        self.kv.init("w", self.w)
        self.opt = mt.optimizer.create(optimizer, learning_rate=SPARSE_LR)
        self.w_state = list(self.opt.create_state(0, self.w))
        self.b_state = list(self.opt.create_state(1, self.bias))

    def step(self, torch, csr, by, ev=None):
        """One step of the example's loop: kv.row_sparse_pull of the
        batch's rows, Embedding(sparse_grad=True) over the CSR's column
        ids, the log loss, the lazy update, kv.push.  With ``ev`` (four
        CUDA events: step start, update start and end, step end) the
        lazy update runs where any wait of the host on the card raises.
        Returns (the loss tensor, the pulled RowSparseNDArray, the
        weight's tensor when it was pulled: an update binds a new one)."""
        mt, w = self.mt, self.w
        if ev:
            ev[0].record()
        pulled = mt.nd.sparse.zeros("row_sparse", w.shape, ctx=self.ctx)
        self.kv.row_sparse_pull("w", out=pulled, row_ids=csr.indices)
        w_pulled = w.as_torch()
        shape = (SPARSE_BATCH, SPARSE_NNZ)
        bc = mt.nd.NDArray(csr.indices.as_torch().view(shape))
        bv = mt.nd.NDArray(csr.data.as_torch().view(shape))
        with mt.autograd.record():
            emb = mt.nd.Embedding(bc, w, input_dim=SPARSE_FEATURES,
                                  output_dim=1, sparse_grad=True)
            p = mt.nd.sigmoid((emb.reshape(shape) * bv).sum(axis=1)
                              + self.bias)
            loss = -(by * mt.nd.log(p + 1e-7)
                     + (1 - by) * mt.nd.log(1 - p + 1e-7)).mean()
        loss.backward()
        if w.grad.stype != "row_sparse":
            raise RuntimeError("sparse_linear: the gradient densified")
        if ev:
            ev[1].record()
            torch.cuda.set_sync_debug_mode("error")
        try:
            self.opt.update(0, w, w.grad, self.w_state)
        finally:
            if ev:
                torch.cuda.set_sync_debug_mode(0)
        if ev:
            ev[2].record()
        self.opt.update(1, self.bias, self.bias.grad, self.b_state)
        self.kv.push("w", w)
        if ev:
            ev[3].record()
        return loss.as_torch().detach(), pulled, w_pulled

    def tensors(self):
        return [self.w.as_torch()] + [s.as_torch() for s in self.w_state]


def linear_steps(torch, run, batches, steps, timing=False):
    """``steps`` steps of ``run`` over ``batches`` ((csr, label) pairs)
    in turn.  With ``timing`` (the card): each step's and each lazy
    update's ms by CUDA events, and the pulled rows held bit for bit
    against the weight's as it was when they were pulled.  Returns
    (losses, row), the row with the densify count's change."""
    start = run.mt.nd.sparse.DENSIFY_COUNT
    losses, step_ms, update_ms, rows, pull_bad = [], [], [], [], 0
    for i in range(steps):
        ev = [torch.cuda.Event(enable_timing=True) for _ in range(4)] \
            if timing else None
        loss, pulled, w_pulled = run.step(torch, *batches[i % len(batches)],
                                          ev=ev)
        losses.append(loss)
        if timing:
            ev[3].synchronize()
            step_ms.append(ev[0].elapsed_time(ev[3]))
            update_ms.append(ev[1].elapsed_time(ev[2]))
            idx = pulled.indices.as_torch()
            rows.append(int(idx.shape[0]))
            pull_bad += not torch.equal(pulled.data.as_torch(),
                                        w_pulled.index_select(0, idx))
    row = dict(densified=run.mt.nd.sparse.DENSIFY_COUNT - start,
               step_ms=step_ms, update_ms=update_ms, rows=rows,
               pull_mismatches=pull_bad)
    return [float(v) for v in losses], row


def max_excess(a, b, tol):
    """The largest |a - b| - (atol + rtol |b|) (at most 0 within ``tol``)
    and the largest |a - b|, of two tensors on the CPU."""
    d = (a - b).abs()
    return (float((d - tol["atol"] - tol["rtol"] * b.abs()).max()),
            float(d.max()))


def phase_sparse_linear(torch, mt):
    """examples/sparse/linear_classification.py at avazu-app's width: the
    rows written as a LibSVM file and read back by LibSVMIter as CSR
    batches, moved to the card; lazy SGD, then lazy Adam, 3 + 10 steps
    each through the example's loop, each step checking the store's
    row_sparse_pull against the weight; the same steps on the CPU from
    the same batches.  Correct: no densify, untouched weight and state
    rows bit-identical (0), pulled rows bit-identical, csr.dot = the
    dense product, card = CPU within SPARSE_TOL, the loss falling."""
    dev = mt.gpu(0)
    t0 = time.monotonic()
    cols, vals, y = sparse_dataset(SEED + 80)
    gen_s = time.monotonic() - t0
    fails, row = [], dict(features=SPARSE_FEATURES, nnz=SPARSE_NNZ,
                          batch=SPARSE_BATCH, batches=SPARSE_BATCHES,
                          lr=SPARSE_LR, data_s=gen_s)
    with tempfile.TemporaryDirectory() as workdir:
        path = os.path.join(workdir, "train.libsvm")
        t0 = time.monotonic()
        write_libsvm(path, cols, vals, y)
        row["libsvm_mb"] = os.path.getsize(path) / 2 ** 20
        it = mt.io.LibSVMIter(data_libsvm=path, data_shape=(SPARSE_FEATURES,),
                              batch_size=SPARSE_BATCH)
        host = [(b.data[0], b.label[0]) for b in it]
        row["libsvm_read_s"] = time.monotonic() - t0
    if [c.stype for c, _ in host] != ["csr"] * SPARSE_BATCHES:
        fails.append("LibSVMIter gave no CSR batches")
    if not np.array_equal(host[0][0].indices.asnumpy(),
                          cols[:SPARSE_BATCH].reshape(-1)):
        fails.append("the CSR's columns are not the file's")
    card = [(c.as_in_context(dev), lab.as_in_context(dev))
            for c, lab in host]
    # csr.dot against the dense product, and its time
    c0 = card[0][0]
    ptr = c0.indptr.as_torch()
    nz = CSR_CHECK_ROWS * SPARSE_NNZ
    sub = mt.nd.sparse.CSRNDArray(c0.data.as_torch()[:nz],
                                  c0.indices.as_torch()[:nz],
                                  ptr[:CSR_CHECK_ROWS + 1],
                                  (CSR_CHECK_ROWS, SPARSE_FEATURES))
    wv = mt.nd.array(np.random.RandomState(SEED + 81).randn(
        SPARSE_FEATURES, 1).astype(np.float32), ctx=dev)
    start = mt.nd.sparse.DENSIFY_COUNT
    got = sub.dot(wv).as_torch()
    timed(row, "csr_dot_ms", lambda: c0.dot(wv))
    if mt.nd.sparse.DENSIFY_COUNT != start:
        fails.append("csr.dot densified")
    want = torch.mm(sub.todense().as_torch(), wv.as_torch())
    row["csr_dot_max_abs_err"] = float((got - want).abs().max())
    if not torch.allclose(got, want, **CSR_DOT_TOL):
        fails.append(f"csr.dot off by {row['csr_dot_max_abs_err']}")
    del want, sub
    torch.cuda.empty_cache()
    touched = torch.zeros(SPARSE_FEATURES, dtype=torch.bool, device="cuda")
    for c, _ in card:
        touched[c.indices.as_torch()] = True
    steps = SPARSE_WARMUP + SPARSE_STEPS
    for name in ("sgd", "adam"):
        reset_counts(mt)
        run = LinearRun(mt, name, dev)
        losses, r = linear_steps(torch, run, card, steps, timing=True)
        counts = read_counts(mt)
        tensors = run.tensors()
        cpu_run = LinearRun(mt, name, mt.cpu())
        closses, _ = linear_steps(torch, cpu_run, host, steps)
        # idle share and launches a step: two more steps under the profiler
        ms, busy, kernels = profiled_window(
            torch, lambda: linear_steps(torch, run, card, 1), 2)
        untouched_ok = all(
            bool(t[~touched].view(torch.int32).eq(0).all())
            for t in tensors)
        excess = [max_excess(a.cpu(), b, SPARSE_TOL[name])
                  for a, b in zip(tensors, cpu_run.tensors())]
        timed_ms = r["step_ms"][SPARSE_WARMUP:]
        sub_row = dict(
            median_step_ms=float(np.median(timed_ms)),
            min_step_ms=min(timed_ms), max_step_ms=max(timed_ms),
            update_ms=float(np.median(r["update_ms"][SPARSE_WARMUP:])),
            rows_touched_per_step=float(np.mean(r["rows"])),
            idle_share=1.0 - busy / ms, busy_ms_per_step=busy / 2,
            launches_per_step=sum(k[1] for k in kernels) / 2,
            top_kernels=kernels[:5], losses=losses, cpu_losses=closses,
            max_abs_diff_vs_cpu=[e[1] for e in excess],
            excess_vs_tol=[e[0] for e in excess],
            densified=r["densified"], pull_mismatches=r["pull_mismatches"],
            untouched_rows_bit_identical=untouched_ok,
            attention_launches=counts)
        row[name] = sub_row
        if r["densified"]:
            fails.append(f"{name}: densified {r['densified']} times")
        if r["pull_mismatches"]:
            fails.append(f"{name}: {r['pull_mismatches']} pulls differ")
        if not untouched_ok:
            fails.append(f"{name}: an untouched row changed")
        if max(e[0] for e in excess) > 0:
            fails.append(f"{name}: card vs CPU {excess}")
        if not np.mean(losses[-4:]) < np.mean(losses[:4]):
            fails.append(f"{name}: the loss did not fall {losses}")
        if any(counts[k] for k in ("flash_fwd", "flash_bwd_dq",
                                   "flash_bwd_dkv")):
            fails.append(f"{name}: attention launches {counts}")
    emit("sparse_linear", **row, failures=fails)
    if fails:
        raise RuntimeError("sparse_linear: " + "; ".join(fails))
    return row


def tower_stream(torch, seed, device="cuda"):
    """The example's make_clickstream at MovieLens-20M's size: planted
    rank-4 affinities, each drawn user's top-16 items (scored on the
    card, a chunk of users at a time) as its positives' pool, uniform
    negatives; (users, items, labels) as float32 numpy, shuffled."""
    rng = np.random.RandomState(seed)
    events = TOWER_BATCH * TOWER_BATCHES // 2
    U = torch.from_numpy(rng.randn(TOWER_USERS, TOWER_RANK).astype(
        np.float32)).to(device)
    V = torch.from_numpy(rng.randn(TOWER_ITEMS, TOWER_RANK).astype(
        np.float32)).to(device)
    users = rng.randint(0, TOWER_USERS, events)
    picks = rng.randint(0, TOWER_POOL, events)
    neg = rng.randint(0, TOWER_ITEMS, events)
    uniq, inv = np.unique(users, return_inverse=True)
    uq = torch.from_numpy(uniq).to(device)
    pools = torch.cat([torch.topk(U[uq[k:k + 4096]] @ V.T, TOWER_POOL,
                                  dim=1).indices
                       for k in range(0, len(uniq), 4096)]).cpu().numpy()
    pos = pools[inv, picks]
    u = np.concatenate([users, users])
    i = np.concatenate([pos, neg])
    yl = np.concatenate([np.ones(events, np.float32),
                         np.zeros(events, np.float32)])
    perm = rng.permutation(len(yl))
    return (u[perm].astype(np.float32), i[perm].astype(np.float32),
            yl[perm])


def tower_steps(torch, mt, towers, trainer, batches, steps, timing=False):
    """The example's train step (score = sum(user * item), the squared
    error summed, trainer.step(batch)) over ``batches`` in turn; with
    ``timing``, each step's ms by CUDA events."""
    user_tower, item_tower = towers
    losses, step_ms = [], []
    for k in range(steps):
        uids, iids, label = batches[k % len(batches)]
        if timing:
            ev = [torch.cuda.Event(enable_timing=True) for _ in range(2)]
            ev[0].record()
        with mt.autograd.record():
            score = mt.nd.sum(user_tower(uids) * item_tower(iids), axis=1)
            loss = mt.nd.sum((score - label) ** 2)
        loss.backward()
        trainer.step(TOWER_BATCH)
        losses.append(loss.as_torch().detach())
        if timing:
            ev[1].record()
            ev[1].synchronize()
            step_ms.append(ev[0].elapsed_time(ev[1]))
    return [float(v) for v in losses], step_ms


def tower_pair(mt, ctx, init=None, dtype="float32"):
    """The two sparse-gradient towers on ``ctx``, from Normal(0.3) or
    from ``init`` (the user and item tables) and their Trainer."""
    towers = []
    for n, prefix, k in ((TOWER_USERS, "user_embed_", 0),
                         (TOWER_ITEMS, "item_scores_", 1)):
        t = mt.gluon.nn.Embedding(n, TOWER_DIM, sparse_grad=True,
                                  prefix=prefix, dtype=dtype)
        t.initialize(mt.init.Normal(0.3), ctx=ctx)
        if init is not None:
            t.weight.set_data(mt.nd.array(init[k], ctx=ctx, dtype=dtype))
        towers.append(t)
    params = [p for t in towers for p in t.collect_params().values()]
    trainer = mt.gluon.Trainer(params, "sgd", {"learning_rate": TOWER_LR},
                               kvstore="device")
    return towers, trainer


def phase_two_tower_fit(torch, mt):
    """examples/recommender/two_tower.py's train at MovieLens-20M's size:
    two Gluon Embeddings with sparse_grad=True through
    Trainer(kvstore='device') and SGD, 3 + 10 steps of batch 8192, and
    the same steps on the CPU from the card's initial tables.  Correct:
    card = CPU within TOWER_TOL, no densify, rows no batch read
    bit-identical to the start, the loss falling, no attention launch."""
    dev = mt.gpu(0)
    fails = []
    mt.random.seed(SEED + 91)
    u, i, yl = tower_stream(torch, SEED + 90)
    B = TOWER_BATCH

    def batches(ctx):
        return [tuple(mt.nd.array(a[k * B:(k + 1) * B], ctx=ctx)
                      for a in (u, i, yl)) for k in range(TOWER_BATCHES)]
    towers, trainer = tower_pair(mt, dev)
    init = [t.weight.data().asnumpy() for t in towers]
    steps = TOWER_WARMUP + TOWER_STEPS
    reset_counts(mt)
    start = mt.nd.sparse.DENSIFY_COUNT
    losses, step_ms = tower_steps(torch, mt, towers, trainer, batches(dev),
                                  steps, timing=True)
    densified = mt.nd.sparse.DENSIFY_COUNT - start
    counts = read_counts(mt)
    card = [t.weight.data().asnumpy() for t in towers]
    kind = type(trainer._kvstore).__name__, trainer._kvstore.type
    ctowers, ctrainer = tower_pair(mt, mt.cpu(), init)
    closses, _ = tower_steps(torch, mt, ctowers, ctrainer,
                             batches(mt.cpu()), steps)
    cpu = [t.weight.data().asnumpy() for t in ctowers]
    # idle share: two more card steps under the profiler
    pb = batches(dev)
    ms, busy, kernels = profiled_window(
        torch, lambda: tower_steps(torch, mt, towers, trainer, pb, 1), 2)
    untouched = []
    for w0, w1, ids in ((init[0], card[0], u[:B * TOWER_BATCHES]),
                        (init[1], card[1], i[:B * TOWER_BATCHES])):
        rows = np.setdiff1d(np.arange(len(w0)), ids.astype(np.int64))
        untouched.append((len(rows), bool(np.array_equal(
            w1[rows].view(np.int32), w0[rows].view(np.int32)))))
    diffs = [float(np.abs(a - b).max()) for a, b in zip(card, cpu)]
    close = all(np.allclose(a, b, **TOWER_TOL) for a, b in zip(card, cpu))
    timed_ms = step_ms[TOWER_WARMUP:]
    row = dict(users=TOWER_USERS, items=TOWER_ITEMS, dim=TOWER_DIM,
               batch=B, batches=TOWER_BATCHES, lr=TOWER_LR,
               median_step_ms=float(np.median(timed_ms)),
               min_step_ms=min(timed_ms), max_step_ms=max(timed_ms),
               samples_per_s=B / float(np.median(timed_ms)) * 1e3,
               idle_share=1.0 - busy / ms, busy_ms_per_step=busy / 2,
               launches_per_step=sum(k[1] for k in kernels) / 2,
               top_kernels=kernels[:5], losses=losses, cpu_losses=closses,
               max_abs_diff_vs_cpu=diffs, untouched_rows=untouched,
               densified=densified, store=kind, attention_launches=counts)
    if densified:
        fails.append(f"densified {densified} times")
    if not close:
        fails.append(f"card vs CPU {diffs}")
    if not all(ok for _, ok in untouched):
        fails.append(f"an untouched row changed {untouched}")
    if not np.mean(losses[-3:]) < np.mean(losses[:3]):
        fails.append(f"the loss did not fall {losses}")
    if kind != ("KVStore", "device"):
        fails.append(f"the trainer's store is {kind}")
    if any(counts[k] for k in ("flash_fwd", "flash_bwd_dq",
                               "flash_bwd_dkv")):
        fails.append(f"attention launches {counts}")
    emit("two_tower_fit", **row, failures=fails)
    if fails:
        raise RuntimeError("two_tower_fit: " + "; ".join(fails))
    return row


def kv_mlp_fit(mt, kvstore, x, yv, args, fname):
    """Module.fit of the MLP on the card (SGD with momentum), its states
    saved to ``fname``: (module, parameters as numpy)."""
    d = mt.sym.Variable("data")
    h = mt.sym.Activation(mt.sym.FullyConnected(
        d, num_hidden=KV_MLP["hidden"], name="fc1"), act_type="relu")
    net = mt.sym.SoftmaxOutput(mt.sym.FullyConnected(
        h, num_hidden=KV_MLP["classes"], name="fc2"), name="softmax")
    mod = mt.mod.Module(net, context=mt.gpu(0))
    it = mt.io.NDArrayIter(x, yv, batch_size=KV_MLP["batch"])
    mod.fit(it, num_epoch=KV_MLP["epochs"], kvstore=kvstore,
            arg_params={k: mt.nd.array(v) for k, v in args.items()},
            optimizer="sgd", optimizer_params={
                "learning_rate": 0.1, "momentum": 0.9, "wd": 1e-4})
    mod.save_optimizer_states(fname)
    return mod, {k: v.asnumpy() for k, v in mod.get_params()[0].items()}


def phase_kv_module_fit(torch, mt):
    """Module.fit of a small MLP with kvstore=mt.kv.create('local'), which
    updates inside the store, against the same fit with kvstore=None:
    the same arithmetic, so the weights and the optimizer states (the
    store writes its updater's blob, the module without one a name ->
    arrays pickle: compared decoded) must be bit-identical."""
    import pickle
    rng = np.random.RandomState(SEED + 95)
    n, f, hdim, c = (KV_MLP[k] for k in ("samples", "features", "hidden",
                                         "classes"))
    x = rng.randn(n, f).astype(np.float32)
    yv = np.argmax(x @ rng.randn(f, c), axis=1).astype(np.float32)
    args = {"fc1_weight": (rng.randn(hdim, f) * 0.1).astype(np.float32),
            "fc1_bias": np.zeros(hdim, np.float32),
            "fc2_weight": (rng.randn(c, hdim) * 0.1).astype(np.float32),
            "fc2_bias": np.zeros(c, np.float32)}
    fails = []
    with tempfile.TemporaryDirectory() as workdir:
        kv = mt.kv.create("local")
        reset_counts(mt)
        reset_r1()
        t0 = time.monotonic()
        mod, got = kv_mlp_fit(mt, kv, x, yv, args,
                              os.path.join(workdir, "kv.states"))
        torch.cuda.synchronize()
        secs = time.monotonic() - t0
        counts, r1 = read_counts(mt), r1_count()
        _, want = kv_mlp_fit(mt, None, x, yv, args,
                             os.path.join(workdir, "plain.states"))
        upd = mt.optimizer.get_updater(mt.optimizer.SGD())
        with open(os.path.join(workdir, "kv.states"), "rb") as fin:
            upd.set_states(fin.read())
        with open(os.path.join(workdir, "plain.states"), "rb") as fin:
            plain = pickle.load(fin)
    on_store = mod._update_on_kvstore and mod._kvstore is kv
    same_w = all(np.array_equal(got[k].view(np.int32), want[k].view(np.int32))
                 for k in args)
    same_s = sorted(upd.states) == sorted(plain) and all(
        np.array_equal(a.asnumpy().view(np.int32),
                       np.asarray(b).view(np.int32))
        for k in plain for a, b in zip(upd.states[k], plain[k]))
    steps = KV_MLP["epochs"] * (n // KV_MLP["batch"])
    emit("kv_module_fit", store=kv.type, update_on_kvstore=on_store,
         steps=steps, seconds=secs, weights_bit_identical=same_w,
         states_bit_identical=same_s, relu_grad_launches=r1,
         attention_launches=counts)
    if not on_store:
        fails.append("the module did not update in the store")
    if not (same_w and same_s):
        fails.append(f"store vs none: weights {same_w}, states {same_s}")
    if r1 != steps:
        fails.append(f"{r1} R1 launches for {steps} steps")
    if any(counts[k] for k in ("flash_fwd", "flash_bwd_dq",
                               "flash_bwd_dkv")):
        fails.append(f"attention launches {counts}")
    if fails:
        raise RuntimeError("kv_module_fit: " + "; ".join(fails))
    return r1



# ---------------------------------------------------------------------------
# C4 and C6: checkpoints and observability on the GPT-2-small-width LM
# ---------------------------------------------------------------------------
# Module.fit of the LM over CKPT_LM["batches"] seeded batches an epoch:
# the main path trains CKPT_LM["save_epochs"] epochs under an asynchronous
# sharded checkpoint and a Monitor, is dropped, and resumes from the
# checkpoint for the last epoch under the profiler; an uninterrupted run
# of all the epochs is the reference it must equal bit for bit
CKPT_LM = dict(batches=4, epochs=3, save_epochs=2, monitor_interval=8,
               predict_batch=2)


class FitStepClock:
    """Batch-end callback: each step's ms (the card synchronised at its
    end, so a step is the time from the last mark to its end), and
    whether a checkpoint write was in flight when the step began; an
    epoch-end ``mark`` restarts the clock after the epoch's callbacks."""

    def __init__(self, torch, ck=None):
        self.torch, self.ck = torch, ck
        self.rows = []
        self.mark()

    def mark(self, *args):
        self.torch.cuda.synchronize()
        self.t = time.perf_counter()
        self.flight = self.ck is not None and self.ck.in_flight()

    def __call__(self, param):
        self.torch.cuda.synchronize()
        t = time.perf_counter()
        self.rows.append(dict(epoch=param.epoch, nbatch=param.nbatch,
                              ms=(t - self.t) * 1e3,
                              save_in_flight=self.flight))
        self.t = t
        self.flight = self.ck is not None and self.ck.in_flight()


def ckpt_lm_iter(mt):
    S, V = GPT2_SMALL["seq_len"], GPT2_SMALL["vocab_size"]
    rng = np.random.default_rng(SEED + 120)
    xs, ys = zip(*[lm_batch(rng, TRAIN_BATCH, S, V)
                   for _ in range(CKPT_LM["batches"])])
    return mt.io.NDArrayIter({"data": np.concatenate(xs)},
                             {"softmax_label": np.concatenate(ys)},
                             batch_size=TRAIN_BATCH)


def ckpt_lm_module(mt, sym, it, arg_params=None, aux_params=None,
                   begin_num_update=0):
    """The LM's Module bound, initialised (from ``arg_params`` or by
    ``train``'s initializer) and given Adam (its step count starting at
    ``begin_num_update``) before ``fit``, so that a step's time holds no
    set-up."""
    mod = mt.mod.Module(sym, context=mt.gpu(0), compute_dtype="bfloat16")
    mod.bind(data_shapes=it.provide_data, label_shapes=it.provide_label)
    mod.init_params(mt.initializer.Xavier(rnd_type="gaussian",
                                          magnitude=2.0),
                    arg_params=arg_params, aux_params=aux_params)
    mod.init_optimizer(optimizer="adam", optimizer_params={
        "learning_rate": TRAIN_LR, "begin_num_update": begin_num_update})
    return mod


def host_params(mod):
    args, aux = mod.get_params()
    return {k: v._data.detach().cpu().clone()
            for k, v in list(args.items()) + list(aux.items())}


def param_diffs(torch, a, b):
    """Names whose tensors differ in a bit, with the largest |a - b|."""
    out = {}
    for k in a:
        if not torch.equal(a[k], b[k]):
            out[k] = float((a[k].float() - b[k].float()).abs().max())
    return out


def phase_ckpt_lm_fit(torch, mt, sym, workdir):
    """The C4 / C6 main path on the GPT-2-small-width LM in bf16 over fp32
    masters (Adam, as ``train``; each Module bound, initialised and given
    its optimizer before ``fit``, so a step's time holds no set-up):
    ``Module.fit`` over two epochs of four steps with
    ``do_checkpoint(prefix, sharded_async=True)`` at each epoch's end
    and a Monitor that observes exactly one step, the
    optimizer states saved at epoch 2, the module dropped; a fresh
    Module from ``load_checkpoint_sharded`` and the states (Adam's step
    count carried by ``begin_num_update``) trains the third epoch inside
    ``profiler_set_state('run'/'stop')`` with ``xla_logdir`` set, then
    ``dump_profile()``.  The result must equal an uninterrupted 3-epoch
    run bit for bit; K1-K3 launch counts are reset just before the main
    path and read just after; the chrome trace must hold the executor's
    and the module's events, the device trace the flash kernels."""
    import gc
    L = GPT2_SMALL["num_layers"]
    nb, epochs, save_ep = (CKPT_LM[k] for k in ("batches", "epochs",
                                                "save_epochs"))
    fails = []
    # the uninterrupted reference run
    t0 = time.monotonic()
    mt.random.seed(SEED)
    it = ckpt_lm_iter(mt)
    ref = ckpt_lm_module(mt, sym, it)
    ref_clock = FitStepClock(torch)
    ref_peaks = []

    def peak_mark(peaks):
        """An epoch-end callback: the epoch's peak device memory."""
        def mark(*args):
            torch.cuda.synchronize()
            peaks.append(torch.cuda.max_memory_allocated())
            torch.cuda.reset_peak_memory_stats()
        return mark
    torch.cuda.synchronize()
    torch.cuda.reset_peak_memory_stats()
    ref.fit(it, num_epoch=epochs, batch_end_callback=ref_clock,
            epoch_end_callback=[peak_mark(ref_peaks), ref_clock.mark],
            eval_metric=mt.metric.CrossEntropy())
    want = host_params(ref)
    ref_s = time.monotonic() - t0
    del ref
    gc.collect()
    torch.cuda.empty_cache()

    # the main path: counts from 0 just before, read just after
    prefix = os.path.join(workdir, "lm")
    reset_counts(mt)
    t0 = time.monotonic()
    mt.random.seed(SEED)
    it = ckpt_lm_iter(mt)
    mod = ckpt_lm_module(mt, sym, it)
    ckpt = mt.callback.do_checkpoint(prefix, sharded_async=True)
    ck = ckpt.checkpointer
    kept = []

    class KeptMonitor(mt.Monitor):
        def toc_print(self):
            res = super().toc_print()
            if res:
                kept.append(res)
            return res
    # the Monitor's step count starts two short of its interval, so the
    # one step it observes is epoch 0's third, a steady one
    mon = KeptMonitor(CKPT_LM["monitor_interval"])
    mon.step = CKPT_LM["monitor_interval"] - 2
    peaks = []
    torch.cuda.synchronize()
    torch.cuda.reset_peak_memory_stats()
    clock = FitStepClock(torch, ck)
    mod.fit(it, num_epoch=save_ep, batch_end_callback=clock,
            epoch_end_callback=[peak_mark(peaks), ckpt, clock.mark],
            monitor=mon,
            eval_metric=mt.metric.CrossEntropy())
    states = f"{prefix}-{save_ep:04d}.states"
    mod.save_optimizer_states(states)
    ck.wait(timeout=300)
    del mod
    gc.collect()
    torch.cuda.empty_cache()
    # resume: a fresh Module from the sharded checkpoint and the states
    t1 = time.monotonic()
    sym2, arg, aux = mt.checkpoint.load_checkpoint_sharded(prefix, save_ep)
    load_s = time.monotonic() - t1
    it = ckpt_lm_iter(mt)
    res = ckpt_lm_module(mt, sym2, it, arg, aux,
                         begin_num_update=save_ep * nb)
    res.load_optimizer_states(states)
    profile_json = os.path.join(workdir, "profile.json")
    logdir = os.path.join(workdir, "device_trace")
    mt.profiler.profiler_set_config(mode="symbolic", filename=profile_json,
                                    xla_logdir=logdir)
    res_clock = FitStepClock(torch)
    mt.profiler.profiler_set_state("run")
    res.fit(it, begin_epoch=save_ep, num_epoch=epochs,
            batch_end_callback=res_clock,
            eval_metric=mt.metric.CrossEntropy())
    mt.profiler.profiler_set_state("stop")
    mt.profiler.dump_profile()
    mt.profiler.profiler_set_config(xla_logdir="")
    torch.cuda.synchronize()
    path_s = time.monotonic() - t0
    counts = read_counts(mt)
    dispatch = mt.profiler.dispatch_counts()
    got = host_params(res)

    steps = epochs * nb
    want_counts = {"flash_fwd": L * steps, "flash_fwd_lse": L * steps,
                   "flash_bwd_dq": L * steps, "flash_bwd_dkv": L * steps,
                   "nms_suppress": 0}
    if counts != want_counts:
        fails.append(f"launches {counts}, want {want_counts}")
    if dispatch.get("module.update") != steps \
            or dispatch.get("module.backward") != steps:
        fails.append(f"dispatches {dispatch}, want {steps} updates and "
                     "backwards")
    diffs = param_diffs(torch, got, want)
    if sorted(got) != sorted(want) or diffs:
        worst = sorted(diffs.items(), key=lambda kv: -kv[1])[:8]
        fails.append(f"resumed run differs from the uninterrupted one in "
                     f"{len(diffs)} of {len(want)} arrays, worst {worst}")
    finite = all(bool(torch.isfinite(v.float()).all()) for v in got.values())
    if not finite:
        fails.append("non-finite parameters after the resumed epoch")
    # the Monitor: exactly one step observed, every node's output
    stats = [float(v) for _, _, v in kept[0]] if len(kept) == 1 else []
    if len(kept) != 1 or not stats or not np.all(np.isfinite(stats)):
        fails.append(f"monitor: {len(kept)} steps observed, want 1 "
                     f"with finite statistics")
    # the checkpoints on disk: every epoch's, loadable
    saved = sorted(r["prefix"] for r in ck.saves)
    if saved != [f"{prefix}-{e + 1:04d}.params" for e in range(save_ep)]:
        fails.append(f"async saves {saved}")
    # the chrome trace: the executor's and the module's events, once a
    # step of the profiled epoch
    with open(profile_json) as f:
        host_names = [e["name"] for e in json.load(f)["traceEvents"]]
    host_counts = {n: host_names.count(n) for n in (
        "executor_forward", "executor_backward", "module.forward",
        "module.backward", "module.update")}
    if any(c != nb for c in host_counts.values()):
        fails.append(f"chrome trace events {host_counts}, want {nb} each")
    # the device trace (torch.profiler): the flash kernels by name
    dev_files = mt.profiler.device_trace_files()
    dev_counts = {}
    if dev_files:
        with open(dev_files[-1]) as f:
            evs = json.load(f)["traceEvents"]
        kern = [str(e.get("name", "")) for e in evs
                if e.get("cat") == "kernel"]
        dev_counts = {stem: sum(stem in k for k in kern)
                      for stem in ("flash_fwd", "flash_bwd_dq",
                                   "flash_bwd_dkv")}
    if not dev_files or not all(dev_counts.values()):
        fails.append(f"device trace {dev_files}: flash kernels {dev_counts}")

    def med(rows):
        return float(np.median([r["ms"] for r in rows])) if rows else None
    base = ref_clock.rows[1:]
    monitored = clock.rows[2]
    in_flight = [r for r in clock.rows if r["save_in_flight"]]
    no_flight = [r for r in clock.rows[1:] if not r["save_in_flight"]
                 and r is not monitored]
    saves = [dict(r) for r in ck.saves]
    for r in saves:
        r["write_gb_per_s"] = (r["bytes"] / r["write_s"] / 1e9
                               if r.get("write_s") else None)
        r["d2h_gb_per_s"] = (r["bytes"] / r["d2h_s"] / 1e9
                             if r.get("d2h_s") else None)
    row = dict(
        model="gpt2-small-width", layers=L, batch=TRAIN_BATCH,
        seq=GPT2_SMALL["seq_len"], compute_dtype="bfloat16",
        masters="float32", optimizer=f"adam lr {TRAIN_LR}",
        steps_per_epoch=nb, epochs=epochs, saved_epochs=save_ep,
        resumed_bit_identical=not diffs, arrays=len(want),
        launches=counts, dispatches=dispatch,
        reference_run_s=ref_s, main_path_s=path_s, load_sharded_s=load_s,
        saves=saves, snapshot_bytes=saves[0]["bytes"] if saves else None,
        save_main_thread_ms=[r.get("main_ms") for r in saves],
        step_ms_median_reference=med(base),
        step_ms_median_save_in_flight=med(in_flight),
        step_ms_median_no_save=med(no_flight),
        steps_with_save_in_flight=len(in_flight),
        step_ms_monitored=monitored["ms"],
        step_ms_median_profiled=med(res_clock.rows),
        monitor_stats=len(stats), monitor_interval=CKPT_LM["monitor_interval"],
        epoch_peak_bytes=peaks, reference_epoch_peak_bytes=ref_peaks,
        # epoch 1 runs with epoch 0's save in flight, epoch 0 with none
        # (the reference run's peaks differ from both by the allocator's
        # history, by 0.44 GB on an H100, so they are no baseline)
        peak_added_bytes_in_flight=peaks[1] - peaks[0],
        chrome_trace_events=host_counts, device_trace_kernels=dev_counts,
        step_rows=clock.rows, resumed_step_rows=res_clock.rows,
        reference_step_rows=ref_clock.rows)
    emit("ckpt_lm_fit", **row)
    if fails:
        raise RuntimeError("ckpt_lm_fit: " + "; ".join(fails))
    return counts, res


def phase_ckpt_reference_params(torch, mt, mod, workdir):
    """The reference MXNet's own ``.params`` container on the card: the
    LM's parameters, taken from card tensors, written in that format and
    read back bit for bit; ``tests/golden/legacy_ndarray.v0`` (bytes the
    original implementation wrote) read; and ``Module.load`` of a
    reference-format checkpoint predicting as the module it came from
    (both in bf16 on the card, so bit for bit)."""
    from mxnet_tpu_torch import compat_serialization as compat
    fails = []
    args, aux = mod.get_params()
    blob = {f"arg:{k}": v for k, v in args.items()}
    blob.update({f"aux:{k}": v for k, v in aux.items()})
    prefix = os.path.join(workdir, "ref")
    mod.symbol.save(f"{prefix}-symbol.json")
    t0 = time.monotonic()
    compat.save_reference_params(f"{prefix}-0003.params", blob)
    write_s = time.monotonic() - t0
    nbytes = os.path.getsize(f"{prefix}-0003.params")
    t0 = time.monotonic()
    back = mt.nd.load(f"{prefix}-0003.params")
    read_s = time.monotonic() - t0
    same = sorted(back) == sorted(blob) and all(
        torch.equal(back[k]._data, v._data.detach().cpu())
        for k, v in blob.items())
    if not same:
        fails.append("the reference-format file does not read back bit "
                     "for bit")
    golden = os.path.join(os.path.dirname(os.path.abspath(__file__)),
                          "tests", "golden", "legacy_ndarray.v0")
    legacy = mt.nd.load(golden)
    legacy_ok = len(legacy) == 6 and all(
        np.array_equal(a.asnumpy(), np.arange(128, dtype=np.float32))
        for a in legacy)
    if not legacy_ok:
        fails.append("legacy_ndarray.v0 did not load as six arange(128)")
    # Module.load of the reference-format checkpoint against the module
    # it came from, on one predict batch
    B, S = CKPT_LM["predict_batch"], GPT2_SMALL["seq_len"]
    x, y = lm_batch(np.random.default_rng(SEED + 121), B, S,
                    GPT2_SMALL["vocab_size"])
    shapes = dict(data_shapes=[mt.io.DataDesc("data", (B, S), np.int32)],
                  label_shapes=[mt.io.DataDesc("softmax_label", (B, S),
                                               np.int32)],
                  for_training=False)
    batch = mt.io.DataBatch([mt.nd.array(x, ctx=mt.cpu())],
                            [mt.nd.array(y, ctx=mt.cpu())])
    loaded = mt.mod.Module.load(prefix, 3, context=mt.gpu(0),
                                compute_dtype="bfloat16")
    loaded.bind(**shapes)
    orig = mt.mod.Module(mod.symbol, context=mt.gpu(0),
                         compute_dtype="bfloat16")
    orig.bind(**shapes)
    orig.set_params(args, aux)
    outs = []
    for m in (orig, loaded):
        m.forward(batch, is_train=False)
        outs.append(m.get_outputs()[0]._data)
    torch.cuda.synchronize()
    predict_same = torch.equal(outs[0], outs[1])
    if not predict_same:
        fails.append("Module.load of the reference checkpoint predicts "
                     "otherwise than the original: max |diff| "
                     f"{float((outs[0] - outs[1]).abs().max())}")
    emit("ckpt_reference_params", arrays=len(blob), file_bytes=nbytes,
         write_s=write_s, read_s=read_s,
         write_gb_per_s=nbytes / write_s / 1e9,
         read_gb_per_s=nbytes / read_s / 1e9, bit_identical=same,
         legacy_v0_loaded=legacy_ok, predict_shape=list(outs[0].shape),
         predict_bit_identical=predict_same)
    if fails:
        raise RuntimeError("ckpt_reference_params: " + "; ".join(fails))


# ---------------------------------------------------------------------------
# E1: the distributed plane (dist_async parameter servers with 2-bit
# compression by Q1; dist_sync over gloo)
# ---------------------------------------------------------------------------
Q1_SOURCE = os.path.join("mxnet_tpu_torch", "csrc", "grad_compress.cu")
Q1_DESIGN = (
    "a grid-stride loop in which a thread takes 16 values by four 16-byte "
    "loads of g and of r, writes four 16-byte stores of the residual and "
    "one 32-bit store of codes (value e at bits 2e); then a loop over the "
    "code bytes left (the tail of n % 16, or every byte when a pointer is "
    "off its 16-byte alignment); blocks of 256, at most 8 a "
    "multiprocessor; __fadd_rn / __fsub_rn and no fast math, so no "
    "contraction and no flush of subnormals")
Q1_LIBRARY = ("none: no one PyTorch call quantizes with error feedback "
              "and packs four codes to a byte")
# the LM's largest key (tok_embed_weight, 50304 x 768) whole and the
# second stripe of the two-server plan (rows 25152:50304), a (1001, 3)
# tensor's stripe from row 333 (offset 999 values: off its 16-byte
# alignment, the byte loop alone), and lengths 16 k + r for every r
Q1_LARGE = (50304, 768)
Q1_STRIPE_ROW = 25152
Q1_TAIL_BASE = 16 * 4096
# the parameter servers of the dist phases: as tools/launch.py -s 2
# starts them (DMLC_ROLE=server, the same command, the CPU), each with 4
# of the machine's 8 cores for its optimizer (the worker waits while
# they apply)
DIST_SERVERS = 2
DIST_SERVER_THREADS = 4
DIST_BIGARRAY_BOUND = 1000000
# dist_async: the LM at full width (train's recipe: bf16 over fp32
# masters, Adam TRAIN_LR on the servers, batch TRAIN_BATCH x 1024), 3
# steps by Module.fit, 3 by run_steps, one profiled step, all 2-bit, then
# one uncompressed step.  The threshold is chosen on the CPU rehearsal
# (tests/torch_numerics.py e1: full width, 2 layers, batch 8) so that a
# few percent of the gradient's values fire a step; the loss over the 7
# compressed steps must fall by DIST_ASYNC_MARGIN nats, fixed from that
# rehearsal
DIST_ASYNC_THRESHOLD = 1.0
DIST_ASYNC_FIT_STEPS = 3
DIST_ASYNC_RUN_STEPS = 3
# the rehearsal at this threshold: 2.6% of the values fired the first
# step, 6.8% the seventh; the loss fell 10.857 -> 10.561 (0.296 nats)
# over the 7 steps; the margin is a third of that drop
DIST_ASYNC_MARGIN = 0.1
# a compressed push moves at most this share of the fp32 bytes (2-bit
# codes are a sixteenth, the frames' headers on top)
DIST_ASYNC_PUSH_SHARE = 1 / 15
# dist_sync: two worker processes on cuda:0 over gloo, the LM at full
# width cut to 2 layers, fp32 (TF32 off), batch 4 x 1024 a rank, Adam,
# 4 steps of Module.fit; against one process on the concatenated batch
# of 8.  Both sum the same gradient terms in another order (two per-rank
# sums, then their sum, against one sum).  Two gates:
# - the first gradient, as the update took it (Adam's first moment after
#   step 1 is (1 - beta1) x the rescaled gradient), within
#   DIST_SYNC_GRAD_RTOL of its norm: the summation order alone.  The CPU
#   rehearsal (tests/torch_numerics.py e1_sync: full width, 2 layers,
#   fp32) puts the gradients 2.6e-7 apart.  A rank that kept its own half
#   batch is about 0.7 away, a rescale not divided by the workers exactly
#   1.0; the phase computes both and fails if either passes.
# - the weights after 4 steps within DIST_SYNC_UPDATE_RTOL of the update's
#   norm.  Adam divides each value's step by the root mean square of its
#   gradient, so where a gradient is near zero the orders' last-bit
#   difference becomes a difference of up to the learning rate, and the
#   next steps' gradients carry it on: the CPU rehearsal's distance grows
#   5.3e-5, 4.1e-4, 2.4e-3, 3.4e-3 over steps 1-4, the card's (whose
#   GEMMs split the batch's sums other ways than the CPU's) reached
#   1.19e-2, the same to the last digit in two calls while two
#   single-process runs there were bit-identical (PERF.md).  The phase
#   prints the card's distance after every step; the gate is twice the
#   card's reading
DIST_SYNC_LAYERS = 2
DIST_SYNC_BATCH = 4
DIST_SYNC_STEPS = 4
DIST_SYNC_LR = 1e-2
DIST_SYNC_UPDATE_RTOL = 2.5e-2
DIST_SYNC_GRAD_RTOL = 1e-5


def q1_count():
    from mxnet_tpu_torch import compression
    return compression.quantize_2bit_cuda.launches


def reset_q1():
    from mxnet_tpu_torch import compression
    compression.quantize_2bit_cuda.launches = 0


def q1_special_values(torch, t, dev):
    t32 = torch.tensor(t, dtype=torch.float32)
    eps = torch.nextafter(t32, torch.tensor(0.0))
    return torch.tensor([float("nan"), float("inf"), -float("inf"), 0.0,
                         -0.0, 1e-40, -3e-39, float(t32), -float(t32),
                         float(eps), -float(eps), 2 * float(t32)],
                        dtype=torch.float32, device=dev)


def q1_same(torch, a, b):
    """Codes or residuals the same: equal bits, or both NaN (the card's
    add returns the canonical NaN where x86's keeps the operand's
    payload)."""
    if a.dtype == torch.uint8:
        return torch.equal(a.cpu(), b.cpu())
    a, b = a.detach().cpu().reshape(-1), b.detach().cpu().reshape(-1)
    nan = torch.isnan(a)
    return torch.equal(nan, torch.isnan(b)) and torch.equal(
        a[~nan].view(torch.int32), b[~nan].view(torch.int32))


def phase_q1_kernel(torch, mt):
    """Q1 against its plain version (``quantize_2bit_plain``) on the same
    card tensors and on the CPU (which equals the JAX package's numpy
    quantizer, tests/test_torch_compression.py), bit for bit in codes
    and residual: the LM's largest key whole (first push, and with a
    residual updated in place) and its second stripe, a stripe off its
    16-byte alignment, every length 16 k + r, with NaN, +-inf, +-0,
    subnormals and +-t placed in, at t 0.5 and 0.1.  Times by CUDA events
    (median of 5 loops, min, max) and the device time (torch.profiler)
    beside the bytes bound and the plain version's time."""
    from mxnet_tpu_torch import compression as comp
    dev = torch.device("cuda", 0)
    gen = torch.Generator(device=dev).manual_seed(SEED + 150)
    cases, fails, rows = [], [], {}

    def rand(shape, scale):
        return torch.randn(shape, generator=gen, device=dev) * scale

    big = rand(Q1_LARGE, 0.6)
    big.view(-1)[:12] = q1_special_values(torch, 0.5, dev)
    cases.append(("largest_key_first_push", big, None, 0.5, False))
    cases.append(("largest_key_residual_in_place", big,
                  rand(Q1_LARGE, 0.3), 0.5, True))
    stripe = big[Q1_STRIPE_ROW:]
    cases.append(("largest_key_stripe1_t0.1", stripe,
                  rand(stripe.shape, 0.05), 0.1, True))
    small = rand((1001, 3), 0.2)
    small.view(-1)[999:1011] = q1_special_values(torch, 0.1, dev)
    cases.append(("misaligned_stripe_t0.1", small[333:],
                  rand((668, 3), 0.05), 0.1, False))
    for r in range(16):
        g = rand((Q1_TAIL_BASE + r,), 0.5)
        g[-12:] = q1_special_values(torch, 0.5, dev)
        cases.append((f"tail_{r}", g, rand(g.shape, 0.2) if r % 2 else None,
                      0.5, bool(r % 4 == 1)))
    for name, g, r, t, in_place in cases:
        r_kernel = None if r is None else r.clone()
        r_plain = None if r is None else r.clone()
        codes, res = comp.quantize_2bit_cuda(g, r_kernel, t)
        again, _ = comp.quantize_2bit_cuda(
            g, None if r is None else r.clone(), t)
        pc, pr = comp.quantize_2bit_plain(g, r_plain, t)
        cc, cr = comp.quantize_2bit_plain(
            g.cpu(), None if r is None else r.cpu(), t)
        torch.cuda.synchronize()
        same = (q1_same(torch, codes, pc) and q1_same(torch, res, pr)
                and q1_same(torch, again, pc) and q1_same(torch, codes, cc)
                and q1_same(torch, res, cr)
                and (not in_place or res.data_ptr() == r_kernel.data_ptr()))
        if not same:
            fails.append(f"{name}: Q1 differs from the plain version")
        fin = torch.isfinite(pr)
        err = float((res.float() - pr)[fin].abs().max()) if fin.any() \
            else 0.0
        fired = sum(int((((pc >> (2 * i)) & 3) != 0).sum())
                    for i in range(4))
        rows[name] = dict(n=g.numel(), threshold=t, residual=r is not None,
                          in_place=in_place, bit_identical=same,
                          max_abs_err=err, fired_share=fired / g.numel())
    timed_rows = {}
    for name, g, r, t, _ in cases[:2]:
        n = g.numel()
        buf = None if r is None else r.clone()
        row = dict(shape=list(g.shape), threshold=t, residual=r is not None)

        def call():
            return comp.quantize_2bit_cuda(g, buf, t)
        timed(row, "kernel_ms", call)
        # the kernel alone, as R1's (phase_r1_kernel)
        codes = torch.empty((n + 3) // 4, dtype=torch.uint8, device=dev)
        out = buf if buf is not None else torch.empty_like(g)
        alone = c_entry_launch(torch, "grad_compress.cu",
                               "mxtt_quantize_2bit", (
                                   g.data_ptr(), None if buf is None
                                   else buf.data_ptr(), out.data_ptr(),
                                   codes.data_ptr(), n, float(t),
                                   dev.index), dev)
        row["device_ms"] = time_ms(alone, iters=20, repeats=5)[0]
        row["device_ms_by"] = ("CUDA events over 20 back-to-back launches "
                               "of the kernel alone, median of 5")
        del codes, out
        timed(row, "plain_ms", lambda: comp.quantize_2bit_plain(g, r, t))
        nbytes = n * (8 if r is None else 12) + (n + 3) // 4
        row.update(bound_bytes=nbytes,
                   bound_ms=nbytes / PEAK_BYTES_PER_S * 1e3,
                   bound_by="bytes", library_ms=None, library=Q1_LIBRARY,
                   max_abs_err=rows[name]["max_abs_err"])
        check_bound_share(row, "device_ms", fails, f"q1 {name}")
        check_bound_share(row, "kernel_ms", fails, f"q1 {name}")
        timed_rows[name] = row
    del cases, big, stripe, small
    torch.cuda.empty_cache()
    emit("q1_kernel", source=Q1_SOURCE, design=Q1_DESIGN, cases=rows,
         timed=timed_rows, failures=fails)
    if fails:
        raise RuntimeError("q1_kernel: " + "; ".join(fails))
    return timed_rows


def free_ports(n):
    """``n`` free TCP ports on the loopback (bound, then released)."""
    import socket
    socks = [socket.socket() for _ in range(n)]
    try:
        for s in socks:
            s.bind(("127.0.0.1", 0))
        return [s.getsockname()[1] for s in socks]
    finally:
        for s in socks:
            s.close()


@contextlib.contextmanager
def server_processes(workdir, num_workers):
    """DIST_SERVERS parameter servers as ``tools/launch.py -s`` starts
    them: the command ``python -c 'import mxnet_tpu_torch'`` with
    DMLC_ROLE=server, DMLC_SERVER_ID, DMLC_NUM_WORKER, DMLC_NUM_SERVER,
    MXT_SERVER_URIS and JAX_PLATFORMS=cpu; yields (uris, processes); any
    still running at the end is killed."""
    root = os.path.dirname(os.path.abspath(__file__))
    uris = ",".join(f"127.0.0.1:{p}" for p in free_ports(DIST_SERVERS))
    procs = []
    try:
        for sid in range(DIST_SERVERS):
            env = dict(os.environ, DMLC_ROLE="server",
                       DMLC_SERVER_ID=str(sid),
                       DMLC_NUM_WORKER=str(num_workers),
                       DMLC_NUM_SERVER=str(DIST_SERVERS),
                       MXT_SERVER_URIS=uris, JAX_PLATFORMS="cpu",
                       OMP_NUM_THREADS=str(DIST_SERVER_THREADS),
                       MXNET_KVSTORE_BIGARRAY_BOUND=str(DIST_BIGARRAY_BOUND),
                       PYTHONPATH=root)
            log = open(os.path.join(workdir, f"server{sid}.log"), "w")
            procs.append(subprocess.Popen(
                [sys.executable, "-c", "import mxnet_tpu_torch"], env=env,
                cwd=root, stdout=log, stderr=subprocess.STDOUT))
            log.close()
        yield uris, procs
    finally:
        for p in procs:
            if p.poll() is None:
                p.kill()
                p.wait()


def worker_env(uris, rank=0, num_workers=1):
    """The worker's DMLC variables (tools/launch.py's), set in this
    process for the phase's duration."""
    keys = dict(DMLC_ROLE="worker", DMLC_WORKER_ID=str(rank),
                DMLC_NUM_WORKER=str(num_workers),
                DMLC_NUM_SERVER=str(DIST_SERVERS), MXT_SERVER_URIS=uris,
                MXNET_KVSTORE_BIGARRAY_BOUND=str(DIST_BIGARRAY_BOUND))
    old = {k: os.environ.get(k) for k in keys}
    os.environ.update(keys)
    return old


def restore_env(old):
    for k, v in old.items():
        if v is None:
            os.environ.pop(k, None)
        else:
            os.environ[k] = v


class PushRecorder:
    """Every (wire key, payload) the store puts on the wire while
    ``on``, from its own ``_wire_push_payload``."""

    def __init__(self, kv):
        self.kv, self.on, self.rows = kv, False, []
        self._orig = kv._wire_push_payload

        def record(wire_key, arr):
            payload = self._orig(wire_key, arr)
            if self.on:
                self.rows.append((wire_key, payload))
            return payload
        kv._wire_push_payload = record

    def fired(self):
        """(values that fired, values) over the recorded 2-bit
        payloads."""
        fired = total = 0
        for _wk, p in self.rows:
            codes = np.asarray(p.data, np.uint8)
            fired += int(sum(((codes >> (2 * i)) & 3 != 0).sum()
                             for i in range(4)))
            total += int(np.prod(p.shape))
        return fired, total


def lm_step_loss(torch, mod, label):
    """The step's mean cross-entropy from the module's outputs (the
    SoftmaxOutput's probabilities) at its labels."""
    out = mod.get_outputs()[0]._data
    lab = label._data.reshape(-1).to(out.device).long()
    p = out.float().gather(1, lab[:, None]).clamp_min(1e-30)
    return float(-p.log().mean())


def dist_async_reference(mt, rows, w0, opt_blob, kv):
    """Replay the servers' arithmetic of one step on the CPU: the port's
    Adam, unpickled from the blob the servers got, on ``decompress`` of
    each recorded payload, from the initial weights ``w0``, stripe by
    stripe on the same wire keys.  Returns {param: numpy weights}."""
    import pickle
    from mxnet_tpu_torch import compression, membership
    from mxnet_tpu_torch.kvstore import _key_int
    upd = mt.optimizer.get_updater(pickle.loads(opt_blob))
    out = {k: v.copy() for k, v in w0.items()}
    for wk, payload in rows:
        base = membership.base_key(wk)
        plan = kv._stripe_plan(base, w0[base].shape)
        if plan is None:
            lo, hi = 0, w0[base].shape[0]
        else:
            i = int(wk.rsplit("@s", 1)[1])
            lo, hi = plan[i], plan[i + 1]
        w = mt.nd.array(w0[base][lo:hi], ctx=mt.cpu())
        upd(_key_int(wk), mt.nd.array(compression.decompress(payload),
                                      ctx=mt.cpu()), w)
        out[base][lo:hi] = w.asnumpy()
    return out


def phase_dist_async_lm_fit(torch, mt, sym):
    """The GPT-2-small-width LM trained over dist_async with 2-bit pushes:
    two parameter-server processes as tools/launch.py starts them (their
    store and Adam on the host), the worker this process on cuda:0 (bf16
    over fp32 masters), ``Module.fit`` for DIST_ASYNC_FIT_STEPS steps and
    ``run_steps`` for DIST_ASYNC_RUN_STEPS (the chunked driver), a
    profiled compressed step split into its parts, then one uncompressed
    step.  Checks: 12 launches a step of each of K1 (with lse), K2, K3;
    one Q1 launch a compressed wire key a step; a compressed step's push
    bytes at most DIST_ASYNC_PUSH_SHARE of the fp32 bytes and every
    pull the full fp32 bytes; after the first step the pulled weights
    equal, bit for bit, the port's CPU Adam replaying the servers'
    arithmetic on the pushed payloads; the loss falls by
    DIST_ASYNC_MARGIN; the servers answer from the host and exit on
    ``close(stop_servers=True)``."""
    import pickle
    from mxnet_tpu_torch import kvstore as kvs
    S, V, L = (GPT2_SMALL[k] for k in ("seq_len", "vocab_size",
                                       "num_layers"))
    B = TRAIN_BATCH
    nsteps = DIST_ASYNC_FIT_STEPS + DIST_ASYNC_RUN_STEPS + 1
    rng = np.random.default_rng(SEED + 130)
    batches = [lm_batch(rng, B, S, V) for _ in range(nsteps + 1)]
    fails = []
    with tempfile.TemporaryDirectory() as workdir, \
            server_processes(workdir, 1) as (uris, procs):
        old_env = worker_env(uris)
        try:
            t0 = time.monotonic()
            xs = np.concatenate([b[0] for b in batches[:3]])
            ys = np.concatenate([b[1] for b in batches[:3]])
            it = mt.io.NDArrayIter({"data": xs}, {"softmax_label": ys},
                                   batch_size=B)
            mod = mt.mod.Module(sym, context=mt.gpu(0),
                                compute_dtype="bfloat16")
            mod.bind(data_shapes=it.provide_data,
                     label_shapes=it.provide_label)
            mt.random.seed(SEED)
            mod.init_params(mt.initializer.Xavier(rnd_type="gaussian",
                                                  magnitude=2.0))
            w0 = {k: v.asnumpy() for k, v in mod.get_params()[0].items()}
            # the store dials the servers (started above) once they listen
            kv = mt.kv.create("dist_async")
            kv.set_gradient_compression({"type": "2bit",
                                         "threshold": DIST_ASYNC_THRESHOLD})
            rec = PushRecorder(kv)
            mod.init_optimizer(kvstore=kv, optimizer="adam",
                               optimizer_params={"learning_rate": TRAIN_LR})
            opt_blob = pickle.dumps(mod._optimizer)
            names = mod._update_names()
            raw_bytes = 4 * sum(int(np.prod(w0[n].shape)) for n in names)
            wire_keys = sum(1 if kv._stripe_plan(n, w0[n].shape) is None
                            else len(kv._stripe_plan(n, w0[n].shape)) - 1
                            for n in names)
            torch.cuda.synchronize()
            setup_s = time.monotonic() - t0

            steps = []
            clock = {"t": time.perf_counter()}

            def wire_mark():
                b = mt.profiler.channel_bytes()
                return b.get("sent", 0), b.get("recv", 0)

            def end_step(label, kind, fired=None, t=None):
                if t is None:
                    torch.cuda.synchronize()
                    t = time.perf_counter()
                sent, recv = wire_mark()
                steps.append(dict(kind=kind,
                                  ms=(t - clock["t"]) * 1e3,
                                  loss=lm_step_loss(torch, mod, label),
                                  push_bytes=sent - clock["sent"],
                                  pull_bytes=recv - clock["recv"],
                                  fired_share=fired))
                clock["t"] = time.perf_counter()
                clock["sent"], clock["recv"] = wire_mark()

            first = {}

            def batch_end(param):
                fired = rec.fired()
                # the step ends here: the replay below is the check's
                # own work
                torch.cuda.synchronize()
                t = time.perf_counter()
                if param.nbatch == 0:
                    rec.on = False
                    want = dist_async_reference(mt, rec.rows, w0, opt_blob,
                                                kv)
                    got = {k: v.asnumpy() for k, v in
                           mod.get_params()[0].items()}
                    diff = [k for k in names if not np.array_equal(
                        got[k].view(np.int32), want[k].view(np.int32))]
                    first.update(keys=len(rec.rows), differ=diff,
                                 max_abs=max(float(np.abs(
                                     got[k] - want[k]).max())
                                     for k in names))
                rec.rows.clear()
                end_step(param.locals["data_batch"].label[0], "fit",
                         fired[0] / max(fired[1], 1), t)
                rec.on = True

            torch.cuda.reset_peak_memory_stats()
            reset_counts(mt)
            reset_q1()
            rec.on = True
            clock["sent"], clock["recv"] = wire_mark()
            clock["t"] = time.perf_counter()
            mod.fit(it, num_epoch=1, kvstore=kv, optimizer="adam",
                    optimizer_params={"learning_rate": TRAIN_LR},
                    eval_metric=mt.metric.CrossEntropy(),
                    batch_end_callback=batch_end)
            # the second epoch through the chunked driver: the push of a
            # chunk and its pull go out while the next chunk computes
            run = batches[3:3 + DIST_ASYNC_RUN_STEPS]
            clock["t"] = time.perf_counter()
            clock["sent"], clock["recv"] = wire_mark()
            outs = mod.run_steps({"data": np.stack([b[0] for b in run])},
                                 {"softmax_label": np.stack(
                                     [b[1] for b in run])})
            torch.cuda.synchronize()
            rs_ms = (time.perf_counter() - clock["t"]) * 1e3
            probs = outs[0]._data
            for j, (_x, y) in enumerate(run):
                lab = torch.from_numpy(y.reshape(-1)).long().to(probs.device)
                p = probs[j].float().gather(1, lab[:, None]).clamp_min(1e-30)
                steps.append(dict(kind="run_steps", ms=rs_ms / len(run),
                                  loss=float(-p.log().mean())))
            fired = rec.fired()
            sent, recv = wire_mark()
            for s in steps[-len(run):]:
                s.update(fired_share=fired[0] / max(fired[1], 1),
                         push_bytes=(sent - clock["sent"]) / len(run))
            # one pull for the chunk, after its last step
            steps[-1].update(pull_bytes=recv - clock["recv"])
            del outs, probs
            rec.on = False
            rec.rows.clear()
            # one profiled compressed step, split into its parts
            x, y = batches[3 + DIST_ASYNC_RUN_STEPS]
            batch = mt.io.DataBatch([mt.nd.array(x, ctx=mt.cpu())],
                                    [mt.nd.array(y, ctx=mt.cpu())])
            ex = mod._exec
            waits = []
            orig_await = kvs._await

            def timed_await(p):
                t = time.perf_counter()
                try:
                    return orig_await(p)
                finally:
                    waits.append(time.perf_counter() - t)
            torch.cuda.synchronize()
            clock["sent"], clock["recv"] = wire_mark()
            with device_window(torch) as prof:
                t_a = time.perf_counter()
                mod.forward(batch, is_train=True)
                mod.backward()
                torch.cuda.synchronize()
                t_b = time.perf_counter()
                kv.push(names, [[ex.grad_dict[n]] for n in names])
                t_c = time.perf_counter()
                kvs._await = timed_await
                try:
                    kv.pull(names, out=[[ex.arg_dict[n]] for n in names])
                finally:
                    kvs._await = orig_await
                torch.cuda.synchronize()
                t_d = time.perf_counter()
            sent, recv = wire_mark()
            kern = device_kernels(prof)

            def dev(*stems):
                return sum(ms for ms, _, k in kern
                           if any(s in k for s in stems))
            busy = sum(ms for ms, _, _ in kern)
            step_ms = (t_d - t_a) * 1e3
            split = dict(
                step_ms=step_ms, compute_ms=(t_b - t_a) * 1e3,
                push_ms=(t_c - t_b) * 1e3,
                q1_device_ms=dev("quantize_2bit_kernel"),
                packed_d2h_device_ms=dev("DtoH", "Device -> Pinned"),
                pull_ms=(t_d - t_c) * 1e3, pull_wait_ms=sum(waits) * 1e3,
                h2d_device_ms=dev("HtoD", "Pageable -> Device"),
                device_busy_ms=busy,
                device_idle_share=max(0.0, 1 - busy / step_ms),
                push_bytes=sent - clock["sent"],
                pull_bytes=recv - clock["recv"],
                top_kernels=[dict(ms=ms, count=c, name=k)
                             for ms, c, k in kern[:8]])
            split["push_submit_ms"] = max(0.0, split["push_ms"] - split[
                "q1_device_ms"] - split["packed_d2h_device_ms"])
            split["h2d_ms"] = split["pull_ms"] - split["pull_wait_ms"]
            steps.append(dict(kind="profiled", ms=step_ms,
                              loss=lm_step_loss(torch, mod, batch.label[0]),
                              push_bytes=split["push_bytes"],
                              pull_bytes=split["pull_bytes"]))
            counts, q1 = read_counts(mt), q1_count()
            # one uncompressed step: the stripes' fp32 bytes to pinned
            # host memory, no Q1
            kv.set_gradient_compression({"type": "none"})
            x, y = batches[-1]
            batch = mt.io.DataBatch([mt.nd.array(x, ctx=mt.cpu())],
                                    [mt.nd.array(y, ctx=mt.cpu())])
            clock["t"] = time.perf_counter()
            clock["sent"], clock["recv"] = wire_mark()
            train_step(mod, batch)
            end_step(batch.label[0], "uncompressed")
            q1_after = q1_count()
            peak = torch.cuda.max_memory_allocated()
            served = [kv.server_stats(i)["server"]
                      for i in range(DIST_SERVERS)]
            devices = [(d["device"], d["cuda_initialized"]) for d in served]
            kv.close(stop_servers=True)
            exits = []
            for p in procs:
                try:
                    exits.append(p.wait(timeout=60))
                except subprocess.TimeoutExpired:
                    exits.append(None)
            total_s = time.monotonic() - t0
        finally:
            restore_env(old_env)
    compressed = [s for s in steps if s["kind"] != "uncompressed"]
    n_comp = len(compressed)
    want = {"flash_fwd": L * n_comp, "flash_fwd_lse": L * n_comp,
            "flash_bwd_dq": L * n_comp, "flash_bwd_dkv": L * n_comp,
            "nms_suppress": 0}
    if counts != want:
        fails.append(f"launches {counts}, want {want}")
    if q1 != wire_keys * n_comp or q1_after != q1:
        fails.append(f"{q1} Q1 launches ({q1_after} after the uncompressed "
                     f"step), want {wire_keys} a compressed step x {n_comp}")
    if first.get("differ"):
        fails.append(f"after the first step {first['differ']} differ from "
                     f"the CPU Adam replay (largest {first['max_abs']})")
    for s in steps:
        if s["kind"] != "uncompressed" and \
                s["push_bytes"] > DIST_ASYNC_PUSH_SHARE * raw_bytes:
            fails.append(f"a compressed step pushed {s['push_bytes']} "
                         f"bytes of {raw_bytes}")
        if s.get("pull_bytes", raw_bytes) < raw_bytes:
            fails.append(f"a pull brought {s['pull_bytes']} < {raw_bytes}")
    if steps[-1]["push_bytes"] < raw_bytes:
        fails.append(f"the uncompressed step pushed {steps[-1]['push_bytes']}"
                     f" < {raw_bytes}")
    losses = [s["loss"] for s in compressed]
    if not all(np.isfinite(losses)) or \
            not losses[-1] < losses[0] - DIST_ASYNC_MARGIN:
        fails.append(f"losses {losses} do not fall by {DIST_ASYNC_MARGIN}")
    if devices != [("cpu", False)] * DIST_SERVERS:
        fails.append(f"servers' (device, CUDA context) {devices}")
    if exits != [0] * DIST_SERVERS:
        fails.append(f"servers exited {exits}")
    emit("dist_async_lm_fit", model="gpt2-small-width", layers=L, batch=B,
         seq=S, servers=DIST_SERVERS,
         servers_device_and_cuda_context=devices,
         server_exit_codes=exits, compute_dtype="bfloat16",
         optimizer=f"adam lr {TRAIN_LR} on the servers",
         compression=f"2bit threshold {DIST_ASYNC_THRESHOLD}",
         wire_keys=wire_keys, raw_push_bytes=raw_bytes, setup_s=setup_s,
         seconds=total_s, steps=steps, margin=DIST_ASYNC_MARGIN,
         first_step_vs_cpu_adam=first, split=split, launches=counts,
         q1_launches=q1, peak_mem_bytes=peak, failures=fails)
    if fails:
        raise RuntimeError("dist_async_lm_fit: " + "; ".join(fails))
    return counts, q1


def dist_sync_lm(mt):
    cfg = dict(GPT2_SMALL, num_layers=DIST_SYNC_LAYERS)
    sym = mt.models.transformer_lm(**cfg)
    return sym, gpt2_params(sym, SEED + 140)


def dist_sync_batches():
    """DIST_SYNC_STEPS global batches of 2 x DIST_SYNC_BATCH rows."""
    rng = np.random.default_rng(SEED + 141)
    S, V = GPT2_SMALL["seq_len"], GPT2_SMALL["vocab_size"]
    return [lm_batch(rng, 2 * DIST_SYNC_BATCH, S, V)
            for _ in range(DIST_SYNC_STEPS)]


def flat_params(mod):
    """The module's weights, by sorted name, as one float32 vector."""
    return np.concatenate([v.asnumpy().ravel() for _, v in
                           sorted(mod.get_params()[0].items())])


def first_moments(mod):
    """Adam's first moment of every weight, by sorted name, as one
    float32 vector: after the first step it is (1 - beta1) times the
    rescaled gradient the update took, the all-reduced one on a
    dist_sync store."""
    upd = mod._updater
    return np.concatenate([
        upd.optimizer._state_tuple(upd.states[k])[0].asnumpy().ravel()
        for k in sorted(upd.states, key=str)])


def rel_distance(a, b, ref):
    """||a - b|| / ||ref||, in float64."""
    d = a.astype(np.float64) - b
    return float(np.sqrt(d @ d) / np.linalg.norm(ref.astype(np.float64)))


def dist_sync_fit(torch, mt, sym, params, x, y, batch, kvstore,
                  on_step=None):
    """Module.fit of the LM in fp32 on cuda:0 over ``x``, ``y`` in batches
    of ``batch``, calling ``on_step(step, module, weights)`` after each
    step (``weights`` from flat_params); (module, sha256 of the weights
    after each step)."""
    import hashlib
    it = mt.io.NDArrayIter({"data": x}, {"softmax_label": y},
                           batch_size=batch)
    mod = mt.mod.Module(sym, context=mt.gpu(0))
    mod.bind(data_shapes=it.provide_data, label_shapes=it.provide_label)
    mod.init_params(arg_params=params)
    hashes = []

    def batch_end(_param):
        flat = flat_params(mod)
        hashes.append(hashlib.sha256(flat.tobytes()).hexdigest())
        if on_step is not None:
            on_step(len(hashes), mod, flat)
    mod.fit(it, num_epoch=1, kvstore=kvstore, optimizer="adam",
            optimizer_params={"learning_rate": DIST_SYNC_LR},
            batch_end_callback=batch_end)
    torch.cuda.synchronize()
    return mod, hashes


def dist_sync_worker(outdir):
    """One rank of phase_dist_sync_fit (``chip_smoke.py --dist-sync-worker
    OUTDIR``, started with tools/launch.py's worker environment).  Its
    JSON has the wall clock (time.time) at each stage of its start-up."""
    marks = {"entered": time.time()}
    import torch
    sys.path.insert(0, os.path.dirname(os.path.abspath(__file__)))
    import mxnet_tpu_torch as mt
    marks["imported"] = time.time()
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    torch.zeros(1, device="cuda")
    marks["cuda_context"] = time.time()
    mt.distributed.initialize()
    rank, world = mt.distributed.rank(), mt.distributed.size()
    marks["gloo_group"] = time.time()
    sym, params = dist_sync_lm(mt)
    glob = dist_sync_batches()
    lo, hi = rank * DIST_SYNC_BATCH, (rank + 1) * DIST_SYNC_BATCH
    x = np.concatenate([b[0][lo:hi] for b in glob])
    y = np.concatenate([b[1][lo:hi] for b in glob])
    marks["weights_and_batches"] = time.time()

    def on_step(step, mod, flat):
        """Rank 0 keeps its weights after each step and, after the first,
        Adam's first moment (from the all-reduced gradient) and the one
        its own half batch alone gives, for the phase's checks."""
        if rank != 0:
            return
        np.save(os.path.join(outdir, f"w{step}.npy"), flat)
        if step == 1:
            np.save(os.path.join(outdir, "m1.npy"), first_moments(mod))
            opt = mod._updater.optimizer
            g = mod._exec.grad_dict
            np.save(os.path.join(outdir, "m1_half.npy"), np.concatenate([
                g[k].asnumpy().ravel() for k in sorted(g)
                if k in mod._param_names]) * np.float32(
                    (1 - opt.beta1) * opt.rescale_grad))
    reset_counts(mt)
    mt.profiler.reset_channel_bytes()
    t0 = time.monotonic()
    mod, hashes = dist_sync_fit(torch, mt, sym, params, x, y,
                                DIST_SYNC_BATCH, "dist_sync", on_step)
    secs = time.monotonic() - t0
    marks["fit_done"] = time.time()
    out = dict(rank=rank, world=world, hashes=hashes, marks=marks,
               launches=read_counts(mt), seconds=secs,
               allgather_bytes=mt.profiler.channel_bytes().get(
                   "allgather", 0),
               kv_type=mod._kvstore.type, num_workers=mod._kvstore.num_workers,
               rescale_grad=mod._updater.optimizer.rescale_grad,
               peak_mem_bytes=torch.cuda.max_memory_allocated())
    with open(os.path.join(outdir, f"rank{rank}.json"), "w") as f:
        json.dump(out, f)
    mt.distributed.shutdown()
    return 0


def phase_dist_sync_fit(torch, mt):
    """Two worker processes on cuda:0 (the environment tools/launch.py -n 2
    gives them: DMLC_PS_ROOT_URI / PORT, DMLC_NUM_WORKER, DMLC_WORKER_ID),
    a gloo group between them, each training the LM at full width cut to
    DIST_SYNC_LAYERS layers by ``Module.fit(kvstore='dist_sync')`` on its
    half of each global batch.  Checks: the ranks' weights bit-identical
    after every step; K1 (with lse), K2, K3 launched once a layer a step
    on each rank; the allgather bytes counted; against one process
    trained here on the concatenated batches, rank 0's first gradient (as
    Adam's first moment) within DIST_SYNC_GRAD_RTOL of its norm, where
    its half batch alone and a doubled rescale both fail, and its
    weights after the last step within DIST_SYNC_UPDATE_RTOL of the
    update's norm."""
    root = os.path.dirname(os.path.abspath(__file__))
    fails = []
    with tempfile.TemporaryDirectory() as workdir:
        port = free_ports(1)[0]
        procs = []
        t0 = time.monotonic()
        spawned = time.time()
        try:
            for r in range(2):
                env = dict(os.environ, DMLC_ROLE="worker",
                           DMLC_PS_ROOT_URI="127.0.0.1",
                           DMLC_PS_ROOT_PORT=str(port), DMLC_NUM_WORKER="2",
                           DMLC_NUM_SERVER="0", DMLC_WORKER_ID=str(r),
                           PYTHONPATH=root)
                log = open(os.path.join(workdir, f"worker{r}.log"), "w")
                procs.append(subprocess.Popen(
                    [sys.executable, os.path.abspath(__file__),
                     "--dist-sync-worker", workdir], env=env, cwd=root,
                    stdout=log, stderr=subprocess.STDOUT))
                log.close()
            # one process on the concatenated batches, here, while the
            # workers start: its weights after each step and its first
            # gradient, for rank 0's to be held against
            sym, params = dist_sync_lm(mt)
            w0 = np.concatenate([params[k].ravel() for k in sorted(params)])
            glob = dist_sync_batches()
            x = np.concatenate([b[0] for b in glob])
            y = np.concatenate([b[1] for b in glob])
            single, grad = [], {}

            def on_step(step, mod, flat):
                single.append(flat)
                if step == 1:
                    grad.update(m1=first_moments(mod), rescale_grad=mod.
                                _updater.optimizer.rescale_grad)
            t1 = time.monotonic()
            mod, _ = dist_sync_fit(torch, mt, sym, params, x, y,
                                   2 * DIST_SYNC_BATCH, None, on_step)
            single_s = time.monotonic() - t1
            del mod
            torch.cuda.empty_cache()
            codes = []
            for p in procs:
                try:
                    codes.append(p.wait(timeout=max(
                        1, 400 - (time.monotonic() - t0))))
                except subprocess.TimeoutExpired:
                    codes.append(None)
        finally:
            for p in procs:
                if p.poll() is None:
                    p.kill()
                    p.wait()
        workers_s = time.monotonic() - t0
        if codes != [0, 0]:
            tails = []
            for r in range(2):
                with open(os.path.join(workdir, f"worker{r}.log")) as f:
                    tails.append(f.read()[-1500:])
            raise RuntimeError(f"dist_sync_fit: workers exited {codes}: "
                               f"{tails}")
        ranks = []
        for r in range(2):
            with open(os.path.join(workdir, f"rank{r}.json")) as f:
                ranks.append(json.load(f))
        upd_rel = []
        for step, flat in enumerate(single, 1):
            got = np.load(os.path.join(workdir, f"w{step}.npy"))
            upd_rel.append(rel_distance(got, flat, flat - w0))
        grad["max_abs"] = float(np.abs(got - flat).max())
        m1 = grad.pop("m1")
        dist = np.load(os.path.join(workdir, "m1.npy"))
        half = np.load(os.path.join(workdir, "m1_half.npy"))
        grad.update(rel=rel_distance(dist, m1, m1),
                    half_batch_rel=rel_distance(half, m1, m1),
                    doubled_rescale_rel=rel_distance(2 * dist, m1, m1))
        del single, m1, dist, half
    startup = {k: [r["marks"][k] - spawned for r in ranks]
               for k in ranks[0]["marks"]}
    L = DIST_SYNC_LAYERS * DIST_SYNC_STEPS
    wantc = {"flash_fwd": L, "flash_fwd_lse": L, "flash_bwd_dq": L,
             "flash_bwd_dkv": L, "nms_suppress": 0}
    for r in ranks:
        if r["launches"] != wantc:
            fails.append(f"rank {r['rank']} launches {r['launches']}, "
                         f"want {wantc}")
        if r["kv_type"] != "dist_sync" or r["num_workers"] != 2:
            fails.append(f"rank {r['rank']}: {r['kv_type']} of "
                         f"{r['num_workers']}")
        if not r["allgather_bytes"]:
            fails.append(f"rank {r['rank']}: no allgather bytes counted")
        if r["rescale_grad"] != grad["rescale_grad"]:
            fails.append(f"rank {r['rank']} rescales by {r['rescale_grad']}"
                         f", one process by {grad['rescale_grad']}")
    if ranks[0]["hashes"] != ranks[1]["hashes"] or \
            len(ranks[0]["hashes"]) != DIST_SYNC_STEPS:
        fails.append("the ranks' weights differ after a step")
    if not grad["rel"] <= DIST_SYNC_GRAD_RTOL:
        fails.append(f"first gradient {grad['rel']} of its norm from the "
                     f"single process (> {DIST_SYNC_GRAD_RTOL})")
    for wrong in ("half_batch_rel", "doubled_rescale_rel"):
        if not grad[wrong] > DIST_SYNC_GRAD_RTOL:
            fails.append(f"the gradient gate passes a wrong reduction "
                         f"({wrong} {grad[wrong]})")
    if len(upd_rel) != DIST_SYNC_STEPS or \
            not upd_rel[-1] <= DIST_SYNC_UPDATE_RTOL:
        fails.append(f"update {upd_rel} of its norm from the single "
                     f"process (> {DIST_SYNC_UPDATE_RTOL})")
    emit("dist_sync_fit", layers=DIST_SYNC_LAYERS, batch_per_rank=
         DIST_SYNC_BATCH, ranks=2, steps=DIST_SYNC_STEPS, dtype="float32",
         optimizer=f"adam lr {DIST_SYNC_LR}",
         cut="full width, 2 of 12 layers (92.2M parameters)",
         workers_s=workers_s, single_process_s=single_s,
         worker_marks_s=startup,
         rank_seconds=[r["seconds"] for r in ranks],
         hashes_equal=ranks[0]["hashes"] == ranks[1]["hashes"],
         allgather_bytes=[r["allgather_bytes"] for r in ranks],
         launches=[r["launches"] for r in ranks],
         peak_mem_bytes=[r["peak_mem_bytes"] for r in ranks],
         first_gradient_vs_single=grad, grad_rtol=DIST_SYNC_GRAD_RTOL,
         update_rel_diff_vs_single_by_step=upd_rel,
         update_rtol=DIST_SYNC_UPDATE_RTOL, failures=fails)
    if fails:
        raise RuntimeError("dist_sync_fit: " + "; ".join(fails))
    return ranks[0]["launches"]


def main():
    try:
        import torch
    except ImportError:
        print("chip_smoke: torch is not installed", file=sys.stderr)
        return 2
    if not torch.cuda.is_available():
        print("chip_smoke: CUDA is not available", file=sys.stderr)
        return 2
    sys.path.insert(0, os.path.dirname(os.path.abspath(__file__)))
    try:
        import mxnet_tpu_torch as mt
    except ImportError as exc:
        print(f"chip_smoke: cannot import mxnet_tpu_torch ({exc}); run "
              "from the root of a checkout", file=sys.stderr)
        return 2
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False

    smi = phase_device(torch)
    phase_build(mt)
    rtc_row = phase_rtc(torch, mt)
    checks = phase_kernels(torch, mt)
    bwd = phase_bwd_kernels(torch, mt)
    nms_rows = phase_nms_kernel(torch, mt)
    r1_rows = phase_r1_kernel(torch, mt)
    q1_rows = phase_q1_kernel(torch, mt)

    sym = mt.models.transformer_lm(**GPT2_SMALL)
    params_np = gpt2_params(sym, SEED)
    serve_counts, pred = phase_serve(torch, mt, sym, params_np)
    phase_profile(torch, pred)
    del pred
    torch.cuda.empty_cache()
    phase_fp32(torch, mt, sym, params_np)
    train_counts = phase_train(torch, mt, sym)
    train_fp32_counts = phase_train_fp32(torch, mt)

    # ResNet-50 (bench.py's path); cuDNN picks its algorithms by timing
    # them, as a user's training script would have it
    torch.backends.cudnn.benchmark = True
    mod, batches, med, resnet_r1 = phase_resnet_train(
        torch, mt, PEAK_FLOPS["bfloat16"])
    phase_resnet_profile(torch, mod, batches, med)
    del mod, batches
    torch.cuda.empty_cache()
    phase_resnet_fp32(torch, mt)
    with tempfile.TemporaryDirectory() as workdir:
        phase_resnet_fit_checkpoint(torch, mt, workdir)
    torch.cuda.empty_cache()

    # KV-cache decode (decode_bench.py's path) and beam search, fp32
    phase_decode(torch, mt, params_np)
    phase_decode_vs_lm(torch, mt, params_np)
    phase_beam(torch, mt, params_np)
    # ViT-S/16 training on the flash kernels, then the zoo's predict
    vit_counts = phase_vit_train(torch, mt)
    zoo_counts = phase_zoo_predict(torch, mt)

    # Gluon: ResNet-50 v1 through gluon.Trainer (hybridized bf16, its
    # profile, imperative), its fp32 step against the CPU, and K1-K3
    # through autograd.record()
    net, trainer, loss_fn, gbatches, gmed = phase_gluon_resnet_train(
        torch, mt, PEAK_FLOPS["bfloat16"])
    phase_gluon_resnet_profile(torch, mt, net, trainer, loss_fn, gbatches,
                               gmed)
    del net, trainer, gbatches
    torch.cuda.empty_cache()
    phase_gluon_resnet_imperative(torch, mt, PEAK_FLOPS["bfloat16"], gmed)
    phase_gluon_fp32(torch, mt)
    gluon_paths = phase_gluon_attention(torch, mt)

    # the RNN family: rnn_bench.py through Module (the fused RNN op on
    # cuDNN), its fp32 step against the CPU, train_ptb.py's bucketing
    # path, and the Gluon LSTM; none of them launches K1-K3
    rnn_ms, rnn_counts = phase_rnn_train(torch, mt, PEAK_FLOPS["bfloat16"])
    phase_rnn_fp32(torch, mt)
    ptb_counts = phase_ptb_bucketing(torch, mt)
    gluon_lstm_paths = phase_gluon_lstm(torch, mt, rnn_ms)
    phase_gluon_lstm_fp32(torch, mt)

    # SSD-VGG16 (BASELINE config 5): training through Module at its
    # published width, detection with the trained parameters through
    # Module.predict, one fp32 step against the CPU; none of them
    # launches K1-K4
    ssd_counts, ssd_params, ssd_x = phase_ssd_train(
        torch, mt, PEAK_FLOPS["bfloat16"])
    ssd_detect_counts, nms_path = phase_ssd_detect(torch, mt, ssd_params,
                                                   ssd_x)
    del ssd_params, ssd_x
    torch.cuda.empty_cache()
    phase_ssd_fp32(torch, mt)

    # the rest of the Gluon zoo at full width, fed by gluon.data and
    # trained through gluon.Trainer (the slice's main path), each
    # network's fp32 step against the CPU, the four Module examples'
    # loss heads, and the dense ops; none of them launches K1-K4 or N1
    # with cuDNN's heuristics: autotuning every convolution of the six
    # networks (cudnn.benchmark) took 72 s of their first steps, and the
    # script keeps under half of its time limit; so these phases' step
    # times (their line says cudnn_benchmark) are not comparable with
    # autotuned ones
    torch.backends.cudnn.benchmark = False
    phase_gluon_zoo_train(torch, mt, PEAK_FLOPS["bfloat16"])
    phase_gluon_zoo_fp32(torch, mt)
    torch.backends.cudnn.benchmark = True
    phase_module_heads(torch, mt)
    phase_dense_ops(torch, mt)

    # C1.b.2: the MoE GPT-2-small LM with the chunked CE head (the slice's
    # main path: K1-K3 twelve times a step each), its fp32 step against
    # the CPU, and the other op families once each
    torch.cuda.empty_cache()
    moe_counts = phase_moe_lm_train(torch, mt, PEAK_FLOPS["bfloat16"])
    phase_moe_fp32(torch, mt)
    phase_ops_c1b2(torch, mt)

    # C8: ResNet-50 trained with LARS by Module.fit from a prefetching
    # iterator, reshaped and scored, its checkpoint fine-tuned with a
    # frozen trunk, and the front end's small checks; none launches K1-K4
    # or N1
    torch.cuda.empty_cache()
    with tempfile.TemporaryDirectory() as workdir:
        prefix = os.path.join(workdir, "lars")
        lars_row = phase_resnet_lars_fit(torch, mt, PEAK_FLOPS["bfloat16"],
                                         prefix)
        phase_resnet_finetune(torch, mt, prefix, lars_row)
    torch.cuda.empty_cache()
    phase_front_end(torch, mt)

    # C3: data IO. The JPEG record file written on the card by nvJPEG,
    # I1 against its plain version, then the slice's main path (ResNet-50
    # v2 by Module.fit from ImageRecordIter: nvJPEG + I1), the raw-record
    # path, SSD from ImageDetRecordIter (I1, and N1 in its detect pass)
    # and the Gluon record dataset; no attention kernel
    torch.cuda.empty_cache()
    with tempfile.TemporaryDirectory() as workdir:
        rec_path, rec_row = phase_rec_write(torch, mt, workdir)
        i1_rows = phase_i1_kernel(torch, mt, rec_path)
        imagenet_row = phase_imagenet_rec_fit(torch, mt, rec_path, med,
                                              PEAK_FLOPS["bfloat16"])
        uint8_row = phase_uint8_rec_fit(torch, mt, rec_path, workdir)
        ssd_rec_counts, ssd_rec_i1 = phase_ssd_rec_fit(torch, mt, workdir)
        phase_rec_dataset(torch, mt, rec_path)

    # C2: sparse storage and the single-process KVStore (the slice's main
    # paths: the sparse linear classifier and the two-tower recommender;
    # then Module.fit through a local store); no attention kernel
    torch.cuda.empty_cache()
    phase_sparse_linear(torch, mt)
    phase_two_tower_fit(torch, mt)
    kv_r1 = phase_kv_module_fit(torch, mt)

    # C4 and C6: the LM trained under an asynchronous sharded checkpoint,
    # a Monitor and the profiler, resumed, against an uninterrupted run
    # (K1-K3, twelve launches a step each); then the reference MXNet's own
    # .params files from the card's tensors
    torch.cuda.empty_cache()
    with tempfile.TemporaryDirectory() as workdir:
        ckpt_counts, ckpt_mod = phase_ckpt_lm_fit(torch, mt, sym, workdir)
        phase_ckpt_reference_params(torch, mt, ckpt_mod, workdir)
        del ckpt_mod
    torch.cuda.empty_cache()

    # E1: the distributed plane.  The LM over dist_async (two parameter
    # servers on the host, 2-bit pushes quantized by Q1 on the card;
    # K1-K3 twelve launches a step), then dist_sync over gloo in two
    # worker processes on the card (K1-K3 in fp32, once a layer a step)
    dist_async_counts, dist_q1 = phase_dist_async_lm_fit(torch, mt, sym)
    torch.cuda.empty_cache()
    dist_sync_counts = phase_dist_sync_fit(torch, mt)
    torch.cuda.empty_cache()

    def by_path(key):
        return {"serve": serve_counts[key], "train": train_counts[key],
                "vit_train": vit_counts[key],
                **{p: c[key] for p, c in gluon_paths.items()},
                "rnn_train": rnn_counts[key],
                "ptb_bucketing": ptb_counts[key],
                **{p: c[key] for p, c in gluon_lstm_paths.items()},
                "ssd_train": ssd_counts[key],
                "ssd_detect": ssd_detect_counts[key],
                "moe_lm_train": moe_counts[key],
                "ssd_rec_fit": ssd_rec_counts[key],
                "ckpt_lm_fit": ckpt_counts[key],
                "dist_async_lm_fit": dist_async_counts[key]}

    def ms_of(row, key):  # the median with its min and max
        return dict(ms=row[key], ms_min=row[f"{key}_min"],
                    ms_max=row[f"{key}_max"])
    fwd, b = checks["main_bf16"], bwd["main_bf16"]
    vf, vb = checks["vit_bf16"], bwd["vit_bf16"]
    f32, mf = checks["vit_fp32"], checks["main_fp32"]

    def f32_fwd_times(row):
        """The fp32 K1's device and host ms beside SDPA's, and its q
        tile, at ``row``'s shape."""
        return {k: row[k] for k in ("kernel_device_ms", "library_device_ms",
                                    "kernel_host_ms", "library_host_ms",
                                    "q_tile")}

    def at_vit(kind, err, ms_key, bound_key, by_key, row):
        """The kernel's numbers at ViT-S/16's shape (B 128, H 6, S 196,
        D 64, non-causal) in ``row``'s dtype."""
        return dict(shape=row["shape"], causal=False, max_abs_err=err,
                    **ms_of(row, ms_key), plain_ms=row["plain_ms"],
                    bound_ms=row[bound_key], bound_by=row[by_key],
                    library_ms=row["library_ms"], kind=kind)
    rows = [
        dict(name="flash_fwd", source="mxnet_tpu_torch/csrc/flash_fwd.cu",
             design="mma.sync (bf16)",
             replaces="mxnet_tpu/ops/attention.py:73", key="flash_fwd",
             max_abs_err=fwd["max_abs_err"], **ms_of(fwd, "kernel_ms"),
             plain_ms=fwd["plain_ms"], bound_ms=fwd["bound_ms"],
             bound_by=fwd["bound_by"], library_ms=fwd["library_ms"],
             at_vit_shape=at_vit("fwd with lse", vf["max_abs_err"],
                                 "kernel_ms", "bound_ms", "bound_by", vf)),
        dict(name="flash_bwd_dq", source="mxnet_tpu_torch/csrc/flash_bwd.cu",
             design="mma.sync (bf16)",
             replaces="mxnet_tpu/ops/attention.py:222", key="flash_bwd_dq",
             max_abs_err=b["dq_max_abs_err"], **ms_of(b, "dq_kernel_ms"),
             plain_ms=b["plain_ms"], bound_ms=b["dq_bound_ms"],
             bound_by=b["dq_bound_by"], library_ms=b["library_ms"],
             at_vit_shape=at_vit("dq", vb["dq_max_abs_err"], "dq_kernel_ms",
                                 "dq_bound_ms", "dq_bound_by", vb)),
        dict(name="flash_bwd_dkv",
             source="mxnet_tpu_torch/csrc/flash_bwd.cu",
             design="mma.sync (bf16)",
             replaces="mxnet_tpu/ops/attention.py:273",
             key="flash_bwd_dkv",
             max_abs_err=max(b["dk_max_abs_err"], b["dv_max_abs_err"]),
             **ms_of(b, "dkv_kernel_ms"), plain_ms=b["plain_ms"],
             bound_ms=b["dkv_bound_ms"], bound_by=b["dkv_bound_by"],
             library_ms=b["library_ms"],
             at_vit_shape=at_vit("dkv", max(vb["dk_max_abs_err"],
                                            vb["dv_max_abs_err"]),
                                 "dkv_kernel_ms", "dkv_bound_ms",
                                 "dkv_bound_by", vb)),
        # the fp32 instance of K1 (CUDA cores), launched on the fp32
        # training step (with lse) and in ViT-S/16's predict in the zoo
        # phase (the one path whose K1 launches are all fp32), at the main
        # shape and at that predict shape
        dict(name="flash_fwd_fp32",
             source="mxnet_tpu_torch/csrc/flash_fwd.cu",
             design=F32_FWD_DESIGN,
             replaces="mxnet_tpu/ops/attention.py:73",
             paths={"train_fp32": train_fp32_counts["flash_fwd"],
                    "zoo_predict": zoo_counts["flash_fwd"]},
             max_abs_err=mf["max_abs_err"], **ms_of(mf, "kernel_ms"),
             plain_ms=mf["plain_ms"], bound_ms=mf["bound_ms"],
             bound_by=mf["bound_by"], library_ms=mf["library_ms"],
             **f32_fwd_times(mf), shape=mf["shape"], causal=True,
             at_vit_predict_shape=dict(
                 shape=f32["shape"], causal=False,
                 max_abs_err=f32["max_abs_err"], **ms_of(f32, "kernel_ms"),
                 plain_ms=f32["plain_ms"], bound_ms=f32["bound_ms"],
                 bound_by=f32["bound_by"], library_ms=f32["library_ms"],
                 **f32_fwd_times(f32))),
    ]
    # the fp32 instances of K2 and K3 (CUDA cores), launched on the fp32
    # training path, at the main shape and at ViT-S/16's training shape
    bf, vbf = bwd["main_fp32"], bwd["vit_fp32"]
    for kind, errs, replaces in (("dq", ("dq",), "222"),
                                 ("dkv", ("dk", "dv"), "273")):
        rows.append(dict(
            name=f"flash_bwd_{kind}_fp32",
            source="mxnet_tpu_torch/csrc/flash_bwd.cu",
            design=F32_BWD_DESIGN[kind],
            replaces=f"mxnet_tpu/ops/attention.py:{replaces}",
            paths={"train_fp32": train_fp32_counts[f"flash_bwd_{kind}"]},
            max_abs_err=max(bf[f"{e}_max_abs_err"] for e in errs),
            **ms_of(bf, f"{kind}_kernel_ms"),
            plain_ms=bf["plain_ms"], bound_ms=bf[f"{kind}_bound_ms"],
            bound_by=bf[f"{kind}_bound_by"], library_ms=bf["library_ms"],
            library="SDPA's fp32 backward (torch.autograd.grad)",
            shape=bf["shape"], causal=True,
            at_vit_shape=at_vit(
                kind, max(vbf[f"{e}_max_abs_err"] for e in errs),
                f"{kind}_kernel_ms", f"{kind}_bound_ms", f"{kind}_bound_by",
                vbf)))
    # K4: the user kernel of the rtc path (the JAX package's Pallas
    # doubler, tests/test_contrib.py:107, launched at :110 through
    # mxnet_tpu/rtc.py:32 PallasKernel)
    rows.append(dict(
        name="rtc_doubler", source=RTC_SOURCE,
        design="float4 loads and stores, a grid-stride loop with four "
        "vectors a thread in flight (a grid of four vectors a thread, "
        "blocks of 256), a scalar tail for n % 4; compiled at runtime by "
        "rtc.CudaModule, called through rtc.CudaFunction (the first "
        "design, one thread an element: first_design_ms)",
        replaces="tests/test_contrib.py:107",
        paths={"rtc": rtc_row["launches"]},
        max_abs_err=rtc_row["max_abs_err"], **ms_of(rtc_row, "kernel_ms"),
        first_design_ms=rtc_row["scalar_kernel_ms"],
        plain_ms=rtc_row["plain_ms"], bound_ms=rtc_row["bound_ms"],
        bound_by=rtc_row["bound_by"], library_ms=rtc_row["library_ms"],
        library="torch.mul(x, 2)", shape=rtc_row["shape"]))
    # the NMS suppression matrix: no TPU kernel's port (the JAX package's
    # NMS is a lax.fori_loop, mxnet_tpu/ops/detection.py:258-266), a
    # hand-written kernel of the detect path all the same; timed on the
    # path's own boxes (ssd_detect's first launch), the stand-ins of
    # nms_kernel beside them
    rows.append(dict(
        name="nms_suppress", source="mxnet_tpu_torch/csrc/nms_overlap.cu",
        design=NMS_DESIGN, replaces="none: the NMS lax.fori_loop of "
        "mxnet_tpu/ops/detection.py:258 and contrib_ops.py:206 (XLA, "
        "not Pallas)", key="nms_suppress",
        max_abs_err=float(max([nms_path["mismatches"]] + [
            r["mismatches"] for r in nms_rows.values()])),
        **ms_of(nms_path, "kernel_ms"), plain_ms=nms_path["plain_ms"],
        bound_ms=nms_path["bound_ms"], bound_by=nms_path["bound_by"],
        library_ms=None, inputs="the detect path's own boxes",
        shape=nms_path["shape"], dtype=nms_path["dtype"],
        candidate_share=nms_path["candidate_share"],
        other_cases={k: dict(ms=nms_rows[k]["kernel_ms"],
                             plain_ms=nms_rows[k]["plain_ms"],
                             bound_ms=nms_rows[k]["bound_ms"],
                             bound_by=nms_rows[k]["bound_by"],
                             candidate_share=nms_rows[k]["candidate_share"])
                     for k in NMS_TIMED}))
    # I1: no TPU kernel's port (the JAX package's decode -> crop -> mirror
    # -> normalize pass is host C++); launched once a batch on the record
    # paths, timed at the main path's shape on its own decoded images
    im, u8 = i1_rows["main"], i1_rows["uint8_nchw"]

    def i1_times(row):
        """ms: the whole call by CUDA events, as every row has it, which
        the wrapper's host time (host_ms) holds where the kernel is
        shorter; device_ms: the kernel alone (CUDA events over launches
        of its C entry)"""
        return dict(shape=row["shape"], **ms_of(row, "kernel_ms"),
                    device_ms=row["device_ms"], host_ms=row["host_ms"],
                    plain_ms=row["plain_ms"],
                    bound_ms=row["bound_ms"], bound_by=row["bound_by"],
                    library_ms=None)
    rows.append(dict(
        name="image_augment", source=I1_SOURCE, design=I1_DESIGN,
        replaces="none: the host C++ mxnet_tpu/native/io_native.cc:250 "
        "jpeg_decode_augment_batch (resize_bilinear :127 folded in; "
        "crop_flip_u8_batch :322 and _nhwc :366 for raw records)",
        paths={"imagenet_rec_fit": imagenet_row["i1_launches"],
               "uint8_rec_fit": uint8_row["i1_launches"],
               "ssd_rec_fit": ssd_rec_i1},
        max_abs_err=max(r["max_abs_err"] for r in i1_rows.values()),
        **i1_times(im), inputs="the record file's first batch decoded "
        "by nvJPEG (500 x 375 and 375 x 500), resized to 256, cropped to "
        "224, mirrored, normalized",
        at_uint8_shape=i1_times(u8),
        other_cases={k: i1_times(i1_rows[k])
                     for k in ("uint8_nhwc", "ragged_299", "failed_slot")},
        decoder=dict(decoder=rec_row["decoder"],
                     backend_counts=rec_row["backend_counts"],
                     decode_images_per_s=rec_row["decode_images_per_s"],
                     pipeline_images_per_s=imagenet_row[
                         "pipeline_images_per_s"])))
    # R1: no TPU kernel's port (jax.nn.relu's gradient rule, which XLA
    # fuses); launched once a relu a step on the ResNet-50 paths, timed at
    # ResNet-50's largest relu
    r1, r1f = r1_rows["resnet50_stage1_bf16"], r1_rows["resnet50_stem_fp32"]

    def r1_times(row):
        """ms by CUDA events, as every row has it; device_ms: the kernel
        alone (torch.profiler)"""
        return dict(shape=row["shape"], dtype=row["dtype"],
                    **ms_of(row, "kernel_ms"), device_ms=row["device_ms"],
                    plain_ms=row["plain_ms"], bound_ms=row["bound_ms"],
                    bound_by=row["bound_by"], library_ms=None,
                    torch_threshold_backward_ms=row[
                        "torch_threshold_backward_ms"])
    rows.append(dict(
        name="relu_grad", source=R1_SOURCE, design=R1_DESIGN,
        replaces="none: jax.nn.relu's gradient rule select(x > 0, g, 0), "
        "which XLA fuses into the backward (the JAX package's "
        "Activation, mxnet_tpu/ops/nn.py:326)",
        paths={"resnet_train": resnet_r1,
               "imagenet_rec_fit": imagenet_row["relu_grad_launches"],
               "uint8_rec_fit": uint8_row["relu_grad_launches"],
               "kv_module_fit": kv_r1},
        max_abs_err=max(r["max_abs_err"] for r in r1_rows.values()),
        **r1_times(r1), at_fp32=r1_times(r1f)))
    # Q1: no TPU kernel's port (the JAX package quantizes on the host with
    # numpy after reading the reduced gradient back); launched once a
    # compressed wire key a step on the dist_async path, timed at the
    # LM's largest key
    q1r, q1f = q1_rows["largest_key_residual_in_place"], \
        q1_rows["largest_key_first_push"]

    def q1_times(row):
        """ms by CUDA events, as every row has it; device_ms: the kernel
        alone (torch.profiler)"""
        return dict(shape=row["shape"], threshold=row["threshold"],
                    residual=row["residual"], **ms_of(row, "kernel_ms"),
                    device_ms=row["device_ms"], plain_ms=row["plain_ms"],
                    bound_ms=row["bound_ms"], bound_by=row["bound_by"],
                    library_ms=None)
    rows.append(dict(
        name="quantize_2bit", source=Q1_SOURCE, design=Q1_DESIGN,
        replaces="none: host numpy mxnet_tpu/compression.py:191 "
        "quantize_2bit, after the worker reads the reduced gradient back "
        "(mxnet_tpu/kvstore.py:2871)",
        paths={"dist_async_lm_fit": dist_q1},
        max_abs_err=max(r["max_abs_err"] for r in q1_rows.values()),
        **q1_times(q1r), library=Q1_LIBRARY, first_push=q1_times(q1f)))
    # the fp32 attention kernels of the dist_sync ranks (each rank's own
    # process; the counts are rank 0's)
    for r in rows:
        if r["name"] in ("flash_fwd_fp32", "flash_bwd_dq_fp32",
                         "flash_bwd_dkv_fp32"):
            r["paths"]["dist_sync_fit_rank0"] = dist_sync_counts[
                r["name"][:-5]]
    kernels = []
    for r in rows:
        paths = r.pop("paths") if "paths" in r else by_path(r.pop("key"))
        kernels.append(dict(name=r.pop("name"), route="cuda",
                            launches=sum(paths.values()),
                            launches_by_path=paths, card=smi, **r))
    # plain_ms and library_ms of the backward kernels (both dtypes) are
    # each of the whole backward (dQ, dK and dV together): the plain
    # version and SDPA's backward compute all three in one call; the
    # fp32 rows' launches are those of the one fp32 training step; the
    # ResNet (Module and Gluon), decode and beam-search paths launch none
    # of them; the zoo phase launches only the fp32 forward (ViT), 12
    # times a batch; the Gluon attention block launches each of K1 (lse),
    # K2 and K3 once a step on each of its two paths
    # no time in the line may beat its bound: a share above
    # BOUND_SHARE_MAX is a wrong measurement, and fails the run
    over = []

    def walk(label, d):
        if not isinstance(d, dict):
            return
        for key in ("ms", "device_ms", "kernel_device_ms"):
            if d.get("bound_ms") and d.get(key) and \
                    d["bound_ms"] / d[key] > BOUND_SHARE_MAX:
                over.append(f"{label} {key} {d[key]} under its bound "
                            f"{d['bound_ms']}")
        for k, v in d.items():
            walk(f"{label}.{k}", v)
    for k in kernels:
        walk(k["name"], k)
    if over:
        raise RuntimeError("kernels: " + "; ".join(over))
    emit("total", seconds=time.monotonic() - T0)
    print(json.dumps({"kernels": kernels}), flush=True)
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": torch.cuda.get_device_name(0),
        "count": torch.cuda.device_count()}}), flush=True)
    return 0


E1_PHASES = ("q1_kernel", "dist_async_lm_fit", "dist_sync_fit")


def run_e1_phases(names):
    """``python3 chip_smoke.py --e1 [PHASE ...]``: the distributed plane's
    phases alone (all three by default), after ``device`` and ``build``,
    with main's backend flags; each prints its line as in the whole
    run."""
    import torch
    if not torch.cuda.is_available():
        print("chip_smoke: CUDA is not available", file=sys.stderr)
        return 2
    sys.path.insert(0, os.path.dirname(os.path.abspath(__file__)))
    import mxnet_tpu_torch as mt
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    phase_device(torch)
    phase_build(mt)
    for name in names or E1_PHASES:
        if name == "dist_async_lm_fit":
            phase_dist_async_lm_fit(
                torch, mt, mt.models.transformer_lm(**GPT2_SMALL))
        else:
            globals()["phase_" + name](torch, mt)
        torch.cuda.empty_cache()
    emit("total", seconds=time.monotonic() - T0)
    return 0


if __name__ == "__main__":
    if len(sys.argv) == 3 and sys.argv[1] == "--dist-sync-worker":
        sys.exit(dist_sync_worker(sys.argv[2]))
    if len(sys.argv) > 1 and sys.argv[1] == "--e1":
        sys.exit(run_e1_phases(sys.argv[2:]))
    sys.exit(main())
