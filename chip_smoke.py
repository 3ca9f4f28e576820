"""Drive the PyTorch/CUDA port (veles_tpu_torch) on one NVIDIA card.

    python3 chip_smoke.py

Phases, each of which fails the run (non-zero exit) when it fails:

1. the card's name and power limit (nvidia-smi);
2. build every kernel of the serving and training paths from
   veles_tpu_torch/ops/csrc with nvcc (sm_90a), all sources at once
   (ptxas's spill bytes for K1, K3 and K4 reported),
   then hold each kernel (K1 paged attention at the burst's lengths and
   at lopsided ones, one slot of 1100 positions beside seven of 0, each
   call twice bit for bit, with its plan printed, K2 the W8A16 product at
   8, 100 and 256 rows, each call twice bit for bit, and one decode
   step's 17 launches replayed from a CUDA graph, K3 int8-KV paged
   attention at the burst's and the lopsided lengths and in heads of
   256, each call twice bit for bit, with its plan printed, K4 dense
   int8-KV attention, on a slab view cut to a span too, twice bit for
   bit, with its plan printed; K1 and K3 also at every head width of
   C4_WIDTHS (8 to 1024, an odd one among them) in 4 heads, K1 in f32
   and bf16 pools and queries, K3 in both query types, each twice bit
   for bit; K1, K3 and K4 at C5_WIDTHS past 1024 (K4 at C5_K4_WIDTHS)
   alike, each timed at D = 2048 beside its byte bound; K1, K3 and K4
   also timed alone by
   torch.profiler, without the events' launch overhead; K5 the
   blocked GEMM at the weight-gradient and grad_x shapes of the wide
   MLP, K6 the fused dense layer at its forward shape, both in bf16 and
   f32 operands, K6 in each activation and at AlexNet's 1000-way head
   with the knobs on, (512, 4096, 1000); K7 the
   flash-attention forward at a ragged serving prefill, bf16 and f32,
   and at the long-context training shape (1, 8192, 8, 128) bf16, K8 and
   K9 its dK/dV and dQ backward at both (bf16); K7, K8 and K9 also at the
   wider heads the flash rule admits, (1, 4096, 4, 256) and (1, 4096, 2,
   384) causal bf16, and f32 K7 at 256) against its plain PyTorch version
   at the path's shapes, and time kernel, plain version and the nearest
   PyTorch library call with CUDA events (L2 flushed before every timed
   launch, median of 25); then one attention() call at 4096 positions
   with 256-wide heads, which must launch K7 once;
3. GenerateAPI at the full width of the repo's serving model (embed
   1024, 16 heads, 4 blocks, vocab 32768, bf16, paged pool of 128-token
   pages, 8 slots) answers 8 concurrent HTTP requests in the float, int8
   and int8-KV tiers; the kernels' launch counters, zeroed before each
   run and read after it, show each run went through its kernels (K2 at
   least 17 times a decode step in both int8 tiers);
4. the repo's shared-prompt traffic (a two-page system prompt, eight
   tails behind it, the system prompt twice more) through GenerateAPI:
   /healthz must count one cold admission, eight tails and two hits;
   then cold against hit admission time on the same decoder;
5. the repo's continuous-serving traffic (bench.py:1044-1121: 16
   prompts of 512 tokens, a budget of 64, chunks of 64, half the
   requests up front and the rest joining one per lag-1 pass) through
   ContinuousDecoder on the dense slot slab, the JAX package's default
   tier, in the float, int8 and int8-KV tiers: a warm run, then a
   measured one whose counters must show K4 (and K2) in the int8-KV
   tier, K2 in the int8 tier and no attention kernel in the float tier;
6. the serving and shared-prompt configurations, and GenerateAPI on the
   dense slab in each tier, in float32 stream the same greedy tokens as
   the port's dense reference decode (on the card for float weights, on
   the CPU for the int8 tiers, where the card would run K2 and K4), up
   to the first step where the reference's top-2 logit gap is below
   1e-3; then per-request sampling: 8 sampled requests (temperature 0.8,
   top-k 50) to ContinuousDecoder at the serving model's width, in
   float32, each request's stream served alone (same request id, another
   slot) equal to its stream in the burst and to generate(batch=1,
   key=request_key(seed, request id)), and the same burst through
   GenerateAPI's HTTP front with temperature and top-k on the API, each
   stream equal to the decoder's for its request id; and, between the
   two, the paged
   pool in heads of 48 (embed 768 = 16 x 48, the serving model's depth
   and vocabulary, f32 weights, float and int8-KV tiers, 8 requests x 16
   tokens) against the dense reference in every compared step; then the
   survival layer at the serving model's width: the circuit breaker in
   the paged float (K1), paged int8-KV (K3) and dense int8-KV (K4 + K2)
   tiers (the shared-prompt mix, a chaos monkey failing one step, the
   mix again with clients retrying: every request 200, /readyz 200, the
   cached prompts hits over the restored pages, the tier's attend
   kernel launched by the rebuilt decoder; trip-to-ready ms by part,
   pages and bytes restored), the paged float tier in f32 after a trip
   against a fault-free run (every stream equal), and the int8 tier's
   live weight swap with a burst in flight (no reply but 200, the burst
   on the old weights, later streams equal a fresh API on the new ones,
   rollback, a NaN checkpoint refused);
7. training: MLPWorkflow over the bench's MNIST-shaped data (60000 x
   784, 10000 valid / 50000 train), 3 epochs at lr 0.03 — the wide MLP
   (784 -> 4096 tanh -> 10, minibatch 4096) with the engine knobs
   use_pallas and pallas_epilogue on (the main path: its counters must
   show K6 once per train and eval minibatch and K5 once per train
   minibatch), then off, off and on again (both orders on one card),
   and the reference MNIST784 configuration (784 -> 100 -> 10,
   minibatch 100); images/s, per-epoch train loss and validation
   errors;
8. one epoch of the wide MLP at precision level 2 (K5 and K6 on f32
   operands) on the card and on the CPU from the same weights: equal
   index streams, per-minibatch errors and final weights within the
   stated tolerances;
9. long prompts: GenerateAPI on the dense slab, bf16, at the serving
   model's width with longctx_device's 8 heads of 128 answers three
   requests at once (prompts of 8192, 6000 and 4096 tokens): each
   prefill launches K7 once per block; then a 4096-token prompt in
   float32 on the card (K7 in f32) against the reference decode on the
   CPU, greedy tokens equal up to the first small top-2 gap;
10. long-context training, the main path of K7, K8 and K9:
   StandardWorkflow with transformer_device's pre-LN stack (4 x
   [layer_norm, residual causal self-attention, layer_norm, residual gelu
   FFN]) at longctx_device's width (embed 1024, 8 heads of 128, 8192
   positions, minibatch 1), a 16-class softmax head, 2 epochs: the
   counters must read K7 once per block per train and valid minibatch,
   K8 and K9 once per block per train minibatch; tokens/s, per-epoch
   loss and validation errors, and the share of the run in K7-K9;
11. transformer_device at its own full width (batch 16, 512 positions,
   16 heads of 64, 256 classes): the plain attention route, no kernel;
12. one epoch of one such block at 4096 positions (embed 256, 2 heads of
   128) on the card (K7-K9) and on the CPU (plain versions) from the
   same weights: equal index streams and per-minibatch errors, every
   weight within 1e-2 of its leaf's largest;
13. (run after phase 8) AlexNet-227 (bench.py:777-817: single tower, 1000
   classes, 1000 valid / 2000 train RandomState(0) pixels, mean_disp,
   level 0): minibatch 128 with the engine knobs at their defaults, 3
   epochs, then minibatch 512 with use_pallas and pallas_epilogue on (the
   main path of K6 forward and K5 backward at its three dense layers,
   counters zeroed before it) and off, 2 epochs each; images/s over the
   run and per epoch, every epoch's loss finite; then one epoch at level
   2 on the card and on the CPU from the same weights of AlexNet at scale
   1/8 on 67 x 67 x 3 pixels and of the digits_conv stack (maxabs
   pooling, shift1 augmentation) on 8 x 8 x 1 pixels: equal index
   streams and augmentation seeds, per-minibatch n_err within 2, every
   leaf within 1e-3 of its largest element;
14. (run after phase 8) graph mode and the lower fusion tiers: the
   reference MNIST784 on the bench data in graph mode, the segment tier
   (a host unit spliced between the forwards), the sweep tier (the same
   unit sweep-transparent) and the fused tick, 2 epochs each: images/s,
   unit firings and composite calls per epoch, the tier asserted; the wide
   MLP in graph mode with the knobs on (K5 three times a train minibatch
   and once an eval one, counted) and off, 2 epochs; one epoch at level 2
   of graph mode on the card against the fused tick on the card and
   against graph mode on the CPU (equal index streams, n_err within 2,
   every leaf within 1e-4 of its largest element);
15. (run after phase 12) the long-context stack of phase 10 in graph mode,
   1 epoch: tokens/s, K7 per block on every minibatch and again on every
   train one (GDSelfAttention's autograd recomputes the forward), K8 and
   K9 per block per train minibatch; one block at 4096 positions in graph
   mode against the fused tick on the card (phase 12's limits); then the
   Kohonen SOM (an (8, 8) grid, minibatch 256, the bench's 60000 x 784
   pixels, 2 epochs): steps/s and the quantization error per epoch, which
   must fall, and one epoch on the card against the CPU (equal winners at
   every step, weights within 1e-4 of the largest).

16. (run after phase 15) the rest of the training surface: MNIST784
   through its idx loader (four idx files, two gzipped, written from the
   bench data at MNIST's 10000 test and 60000 train rows, pixels times 255
   as uint8; samples/mnist784.py's MLPWorkflow(loader_cls=MNISTLoader),
   784 -> 100 tanh -> 10, minibatch 100, lr 0.03, moment 0.9, 3 epochs
   in the fused tick): the loader's arrays equal the written bytes, its
   class lengths [0, 10000, 60000], the train loss falls; the wide MLP
   regressed (evaluator "mse", FullBatchLoaderMSE, one-hot targets), 3
   epochs knobs on, off, off and on: K6 once per train and eval minibatch
   and K5 once per train minibatch with the knobs on (a main path of
   both), the MSE falls; the same model for one epoch in graph mode, the
   sweep tier and the segment tier (the tier asserted); one epoch of it
   at level 2 on the card against the CPU from the same weights (equal
   index streams, losses within 1e-4 relative, leaves within 1e-4 of
   their largest); the eight normalizers' analyze and apply_state on the
   bench's 60000 x 784 pixels on the card against the CPU (within 1e-5 of
   the largest); the first MNIST epoch recorded by MinibatchesSaver
   (shuffling off) and replayed through MinibatchesLoader bit for bit,
   and PicklesLoader and AutoLabelSoundFileLoader on pickles and WAV
   tones the smoke writes, their arrays equal to what was written.

Phase 2's K1, K3 and K4 checks include C6: head widths 8200 to 16384 (K4
8224 to 16384) on the wide path, each timed at D = 16384 beside its byte
bound.

The line before the last is {"kernels": [...]}; the last line is
{"ok": true, "device": {...}}. Without a CUDA device the script exits
non-zero before printing either.
"""

import gzip
import heapq
import json
import math
import os
import pickle
import re
import statistics
import struct
import subprocess
import sys
import tempfile
import threading
import time
import urllib.error
import urllib.request
import wave

import numpy
import torch

from veles_tpu_torch.convert import unit_params_from_jax
from veles_tpu_torch.core import prng
from veles_tpu_torch.core.config import root
from veles_tpu_torch.core.units import Unit
from veles_tpu_torch.dummy import DummyLauncher
from veles_tpu_torch.loader.base import TRAIN, VALID
from veles_tpu_torch.loader.mnist import MNISTLoader
from veles_tpu_torch.loader.normalization import (make_normalizer,
                                                  normalizer_registry,
                                                  state_tensors)
from veles_tpu_torch.loader.pickles import PicklesLoader
from veles_tpu_torch.loader.saver import MinibatchesLoader, MinibatchesSaver
from veles_tpu_torch.loader.sound import AutoLabelSoundFileLoader
from veles_tpu_torch.models.alexnet import AlexNetWorkflow
from veles_tpu_torch.models.kohonen import KohonenWorkflow
from veles_tpu_torch.nn.kohonen import grid_coords, som_step
from veles_tpu_torch.models.mlp import MLPWorkflow
from veles_tpu_torch.models.standard import StandardWorkflow
from veles_tpu_torch.ops import _build
from veles_tpu_torch.ops import activations as act_lib
from veles_tpu_torch.ops.attention import (_flash_attention_dkv_plain,
                                           _flash_attention_dq_plain,
                                           _flash_attention_fwd_plain,
                                           _row_dot, attention,
                                           flash_attention_dkv,
                                           flash_attention_dq,
                                           flash_attention_fwd)
from veles_tpu_torch.ops.gemm import (_blocked_matmul_plain,
                                      _dense_epilogue_plain, blocked_matmul,
                                      dense_epilogue)
from veles_tpu_torch.ops._workspace import sm_count
from veles_tpu_torch.ops.paged_attention import (_paged_attend_int8_plain,
                                                 _paged_attend_plain,
                                                 _paged_plan, paged_attend,
                                                 paged_attend_int8)
from veles_tpu_torch.ops.quant import (_attend_plan, _cache_attend_plain,
                                       _int8_matmul_plain,
                                       int8_cache_attend, int8_matmul,
                                       quantize_int8)
from veles_tpu_torch.parallel.decode import (_quantize_kv, generate,
                                             quantize_params, request_key,
                                             slot_state_bytes)
from veles_tpu_torch.parallel.kv_pool import paged_kv_bytes
from veles_tpu_torch.parallel.segments import FusedSegment
from veles_tpu_torch.parallel.sweep import FusedSweep
from veles_tpu_torch.parallel.transformer_step import (
    init_transformer_params)
from veles_tpu_torch.serving import ContinuousDecoder, GenerateAPI
from veles_tpu_torch.serving_chaos import (ServingChaosConfig,
                                           ServingChaosMonkey)

#: the repo's serving model at full width (bench.py:861-862)
EMBED, HEADS, BLOCKS, VOCAB = 1024, 16, 4, 32768
SLOTS, MAX_LEN, N_TOKENS, CHUNK, PAGE = 8, 1024, 32, 8, 128
#: H100 SXM device memory rate (NVIDIA data sheet), bytes/s, and the
#: dense bf16 tensor-core peak, operations/s
HBM_BYTES_PER_S = 3.35e12
BF16_OPS_PER_S = 989e12
#: K1 at the paged burst's lengths, and lopsided: one slot of 1100
#: positions beside seven of 0
K1_LENGTHS = (0, 127, 128, 300, 511, 700, 1023, 1100)
K1_LOPSIDED = (1100,) + (0,) * 7
#: K1 writes f32 from bf16 inputs that both versions widen exactly;
#: they differ only in summation order and exp over up to 1101
#: positions, far inside this bound
K1_ATOL = 2e-3
#: C4: head widths the JAX package's paged attends serve that K1 and K3
#: had no route for before (the toy models' 8 and 16, rows of 96 to 200
#: bf16 bytes, an odd width) and the widest two powers of two, held in
#: C4_HEADS heads at the burst's lengths, f32 and bf16 pools and queries
C4_WIDTHS = (8, 16, 33, 48, 80, 96, 100, 512, 1024)
C4_HEADS = 4
#: C5: head widths past 1024 the JAX package's attends serve (K4's a
#: multiple of 32: 1056 where K1 and K3 take 1025), held in C4_HEADS heads
#: in both pools and query types; C5_TIMED is timed beside its byte bound
C5_WIDTHS = (1025, 1536, 2048, 4096)
C5_K4_WIDTHS = (1056, 1536, 2048, 4096)
C5_TIMED = 2048
#: C6: head widths past 8192 the JAX package's attends serve, on the wide
#: path (q, K and V read from global memory, the split's sums in its
#: workspace row; K4's a multiple of 32), held in C4_HEADS heads in both
#: pools and query types; C6_TIMED is timed beside its byte bound
C6_WIDTHS = (8200, 12288, 16384)
C6_K4_WIDTHS = (8224, 12288, 16384)
C6_TIMED = 16384
#: the paged serving run in heads of 48: the serving model's depth and
#: vocabulary at embed 768 = 16 x 48, f32 weights, 8 requests x 16 tokens
NARROW_EMBED, NARROW_HEADS, NARROW_TOKENS = 768, 16, 16
#: K3 writes f32 from int8 codes both versions widen exactly and the
#: same f32 scales; they differ only in summation order and exp over up
#: to 1101 positions (~1e-6 of outputs of order 1)
K3_ATOL = 1e-4
#: K2 writes bf16: a one-ulp difference in the final rounding is 2^-8
#: relative, so the bound is 1e-2 of the output's largest magnitude
K2_RTOL = 1e-2
#: K4 writes f32 from int8 codes and f32 scales both versions widen
#: exactly and the same q; they differ only in summation order and exp
#: over 768 positions (~1e-6 of outputs of order 1)
K4_ATOL = 1e-4
#: the dense phase: bench.py's decode_continuous traffic (:1044-1121)
DENSE_PROMPT, DENSE_BUDGET, DENSE_REQUESTS, DENSE_CHUNK = 512, 64, 16, 64
#: two chunks of lag-1 headroom, as there (704; the int8-KV tier rounds
#: it to 768)
DENSE_MAX_LEN = DENSE_PROMPT + DENSE_BUDGET + 2 * DENSE_CHUNK
#: K4 at the dense int8-KV slab's width: ragged lengths (0, a tile
#: boundary, the last position) and the span a slot step cuts
K4_WIDTH, K4_SPAN = 768, 640
K4_LENGTHS = (0, 127, 128, 300, 511, 600, 700, 767)
#: decode-step weight shapes (K, N) and launches of each per step: the
#: four block projections per block, then the vocab head
K2_SHAPES = ((EMBED, 3 * EMBED), (EMBED, EMBED), (EMBED, 4 * EMBED),
             (4 * EMBED, EMBED), (EMBED, VOCAB))
K2_PER_STEP = (BLOCKS, BLOCKS, BLOCKS, BLOCKS, 1)
TOP2_GAP = 1e-3
#: the dense float32 rate outside the tensor cores (NVIDIA data sheet),
#: operations/s: the peak for K5's and K6's f32-operand runs
F32_OPS_PER_S = 67e12
#: K5 and K6 at the training path's shapes (the wide MLP, bench.py:306:
#: 784 -> 4096 (tanh) -> 10 at minibatch 4096): (m, k, n) of the hidden
#: layer's forward (K6), its weight gradient x.T @ err (K5) and the input
#: gradient err @ w.T a deeper eligible layer would take (K5)
K6_SHAPE = (4096, 784, 4096)
K5_SHAPE = (784, 4096, 4096)
K5_GRAD_X_SHAPE = (4096, 4096, 784)
#: K5/K6 write f32 from operands both versions widen exactly; they differ
#: in summation order over up to 4096 terms (~1e-6 of outputs of order
#: 1), far inside this bound relative to the largest output. A bf16
#: output (K5's grad_x) may differ by one bf16 rounding: 2^-8 relative.
GEMM_F32_RTOL = 1e-4
GEMM_BF16_RTOL = 1e-2
#: the training phase: the wide MLP over the bench's data (bench.py:
#: 76-81, 306-356), 3 epochs at lr 0.03, and the reference MNIST784
#: configuration (bench.py:84-98)
WIDE_LAYERS, WIDE_MINIBATCH = (4096, 10), 4096
MNIST_LAYERS, MNIST_MINIBATCH = (100, 10), 100
TRAIN_EPOCHS, TRAIN_LR = 3, 0.03
BENCH_CLASS_LENGTHS = [0, 10000, 50000]
#: the training agreement: one epoch of the wide MLP at precision level
#: 2 (K5 and K6 on f32 operands) on the first 12288 rows of the bench
#: data, 4096 valid and 8192 train
AGREE_CLASS_LENGTHS = [0, 4096, 8192]
#: both sides compute in f32 with other summation orders (~1e-6
#: relative on the logits): an argmax may flip where two logits are
#: that close, so a minibatch's n_err may differ by this many samples
#: of 4096; after two SGD steps at lr 0.03 the weights differed by
#: 7.45e-9 on an H100
AGREE_N_ERR_TOL = 2
AGREE_WEIGHT_ATOL = 1e-4
#: the long-context tier: bench.py's longctx_device head layout (:573,
#: 8 heads of 128) on the serving model's depth, vocabulary and MLP
LONG_HEADS = 8
#: the long-prompt traffic: three requests at once, 32 tokens each; the
#: slab holds the longest with two chunks of lag-1 headroom
LONG_PROMPTS = (8192, 6000, 4096)
LONG_MAX_LEN = max(LONG_PROMPTS) + N_TOKENS + 2 * CHUNK
LONG_AGREE_PROMPT = 4096
#: K7, K8 and K9 at the training shape (longctx_device: batch 1, 8192
#: positions, 8 heads of 128, causal, bf16) and K7 at a ragged serving
#: prefill (2 rows of 5000 positions), as (batch, T, heads, head_dim)
FLASH_TRAIN_SHAPE = (1, 8192, LONG_HEADS, 128)
FLASH_SERVE_SHAPE = (2, 5000, LONG_HEADS, 128)
#: tolerances against the plain versions (computed in f32 from the same
#: inputs), row by row: each row (one position's head_dim values for one
#: head) may differ from its reference row by this much of that row's own
#: norm, so a late row, whose values are ~sqrt(1/T) of the first rows',
#: is held as tightly as an early one. Both sides round the output to
#: bf16 and P (and dS) to bf16 before the products; where the f32 values
#: straddle a rounding boundary an element lands one bf16 step (up to
#: 2^-7 of it) away. K7: such steps in a row of 128 -> 1e-2 (4.5e-3
#: read on an H100). K8 and K9: a late key's dK/dV (an early query's dQ)
#: is one or a few P or dS terms, each possibly a step apart, then the
#: output's own rounding -> 2e-2 (5.6e-3 read). f32 K7 differs only in
#: summation order and exp2 for exp -> 1e-5 (2.8e-6 read).
K7_RTOL, FLASH_BWD_RTOL, K7_F32_RTOL = 1e-2, 2e-2, 1e-5
#: a row whose reference norm is below this share of the median row's is
#: held against that floor: the causal first query's dQ is zero in exact
#: arithmetic (one key: P = 1 and dP = di), so both sides hold rounding
#: noise there (~1e-5 of the median). The smallest true rows, the last
#: keys' dK and dV, are ~5e-3 of the median at 8192 positions: the floor
#: at most doubles their tolerance
FLASH_ROW_FLOOR = 1e-2
#: the planted fault each flash check must see: the last 64 positions'
#: rows (one kernel tile) of the kernel's output scaled by this factor
FLASH_TILE, FLASH_FAULT = 64, 0.9
#: the wider heads the flash rule admits (head_dim % 128 == 0): K7's
#: second wgmma width and the chunked kernels' first, causal bf16, and f32
#: K7 at 256 (batch, T, heads, head_dim)
FLASH_WIDE_SHAPES = ((1, 4096, 4, 256), (1, 4096, 2, 384))
FLASH_WIDE_F32_SHAPE = (1, 4096, 4, 256)
#: the sampled serving phase: 8 requests at the serving model's width,
#: float32 weights: a request's prefill runs in a group of another size
#: alone than in the burst, so its logits differ by the products'
#: round-off, and a bf16 step (2^-8 of a logit) would flip a near-tied
#: Gumbel-max draw where f32's (2^-24) does not
SAMPLE_TEMPERATURE, SAMPLE_TOP_K, SAMPLE_SEED = 0.8, 50, 11
#: the breaker phase's tiers: (label, quantize, paged, attend kernel) —
#: the paged float pool on K1, the paged int8-KV pool on K3, the dense
#: int8-KV slab on K4 (and K2)
BREAKER_TIERS = (("paged float", None, True, "paged_attend"),
                 ("paged int8-kv", "int8-kv", True, "paged_attend_int8"),
                 ("dense int8-kv", "int8-kv", False, "int8_cache_attend"))
#: the breaker's first backoff in the smoke (the default is 0.5 s)
SMOKE_BACKOFF = 0.05
#: the hot swap's second weights: the serving model's width from
#: another seed
SWAP_SEED = 7
#: the long-context training main path: transformer_device's pre-LN stack
#: (bench.py:425-441: 4 x [layer_norm, residual causal self_attention,
#: layer_norm, residual gelu ffn ratio 4], a softmax head) at
#: longctx_device's width and length: 16 samples of (8192, 1024), 4 valid
#: and 12 train, minibatch 1, 16 classes (transformer_throughput's count,
#: bench.py:233), moment 0.9 (bench.py:260), 2 epochs, level 0
LONG_T, LONG_SAMPLES, LONG_CLASSES = 8192, 16, 16
LONG_CLASS_LENGTHS = [0, 4, 12]
LONG_EPOCHS = 2
#: the long-context run's learning rate. bench.py:260's 0.01 sent its
#: loss to NaN in the first epoch: at minibatch 1 one step moves a logit
#: of the head over the flattened T x E = 8.4M features by about lr * T *
#: E (84000 at 0.01). The JAX package and the port diverge alike at lr
#: 0.01 at a smaller T x E (tests/test_torch_transformer.py,
#: test_learning_rate_diverges_alike: both NaN in the second epoch at lr
#: * T * E = 82). 1e-5 keeps that product at 84.
LONG_LR = 1e-5
#: transformer_device at its own full width (bench.py:412-441): batch 16,
#: 512 positions, 16 heads of 64, 256 classes; 64 samples, 16 valid / 48
#: train; bench.py:468's learning rate
TD_T, TD_HEADS, TD_CLASSES, TD_MINIBATCH = 512, 16, 256, 16
TD_LR = 0.01
TD_CLASS_LENGTHS = [0, 16, 48]
TD_EPOCHS = 2
#: the training agreement: one block at 4096 positions, embed 256, 2
#: heads of 128, 4 samples (2 valid, 2 train), minibatch 1, one epoch at
#: level 0, compared on each leaf's update (final minus initial weights:
#: at LONG_LR a weight moves by ~1e-5 of itself, so the weights
#: alone would hide a wrong gradient). Both sides round the projections'
#: operands to bf16; the card also rounds P (K7, K8) and dS (K8, K9) to
#: bf16 (2^-9 relative) where the CPU's plain route keeps f32, and the
#: attention output, rounded to bf16 on both sides, may then land one
#: step (2^-8) apart: every leaf's update must lie within 2e-2 (five such
#: steps) of its largest element, where a wrong gradient is off by O(1).
#: Its two steps run at bench.py:260's lr 0.01, far above the f32 spacing
#: of the weights (two steps cannot diverge)
AGREE_LONG_LR = 0.01
AGREE_T, AGREE_EMBED, AGREE_HEADS = 4096, 256, 2
AGREE_LONG_CLASS_LENGTHS = [0, 2, 2]
AGREE_LONG_RTOL = 2e-2
#: AlexNet-227 (bench.py:777-817): single tower, 1000 classes, RandomState(0)
#: pixels in [0, 255), 1000 valid (one a class) and 2000 train (two a
#: class), mean_disp, precision level 0, the JAX package's lr 0.01, moment
#: 0.9, decay 5e-4; minibatch 128 with the knobs at their defaults, then
#: minibatch 512 with use_pallas and pallas_epilogue on (K6 forward and K5
#: backward at its three dense layers) and off
ALEX_CLASSES, ALEX_HW = 1000, 227
ALEX_CLASS_LENGTHS = [0, 1000, 2000]
ALEX_MINIBATCH, ALEX_EPOCHS = 128, 3
ALEX_KNOBS_MINIBATCH, ALEX_KNOBS_EPOCHS = 512, 2
#: K6 at AlexNet's last hidden layer into the 1000-way head with the knobs
#: on, minibatch 512: (m, k, n)
K6_ALEX_SHAPE = (512, 4096, 1000)
#: the conv agreement, card against CPU, precision level 2, one epoch,
#: per-minibatch serving, from the same weights: AlexNet at scale 1/8 on
#: 67 x 67 x 3 pixels (10 classes, 128 valid / 256 train, minibatch 64),
#: and the digits_conv stack (veles_tpu/parity.py:94-101: conv_tanh 32,
#: maxabs 2x2, conv_tanh 64, tanh 128, softmax) with shift1 on 8 x 8 x 1
#: pixels (297 valid / 1500 train, minibatch 100, lr 0.02, moment 0.9).
#: Both sides compute in f32 with other summation orders (cuDNN's conv
#: algorithms against the CPU's): a near-tied argmax may flip, so a
#: minibatch's n_err may differ by CONV_N_ERR_TOL, and after one epoch
#: every leaf must lie within CONV_LEAF_RTOL of its largest element
CONV_AGREE_SCALE, CONV_AGREE_HW = 1 / 8, 67
CONV_AGREE_CLASS_LENGTHS = [0, 128, 256]
DIGITS_CONV_LAYERS = [
    {"type": "conv_tanh", "n_kernels": 32, "kx": 3, "ky": 3},
    {"type": "maxabs_pooling", "kx": 2, "ky": 2},
    {"type": "conv_tanh", "n_kernels": 64, "kx": 3, "ky": 3},
    {"type": "all2all_tanh", "output_sample_shape": (128,)},
    {"type": "softmax", "output_sample_shape": (10,)}]
DIGITS_CLASS_LENGTHS = [0, 297, 1500]
CONV_N_ERR_TOL, CONV_LEAF_RTOL = 2, 1e-3
#: the fusion tiers (bench.py:150-230): the reference MNIST784 on the
#: bench data in graph mode, the segment tier (a host unit spliced between
#: the two forwards), the sweep tier (the same unit declared
#: sweep_transparent) and the fused tick, 2 epochs each
TIER_EPOCHS = 2
#: the wide MLP in graph mode (level 0, 2 epochs, knobs on and off): K5
#: runs the hidden layer's forward (4096 x 784 x 4096) on every minibatch
#: and its weight gradient (784 x 4096 x 4096) and error product (4096 x
#: 4096 x 784) on every train minibatch; the 10-wide head is no kernel's
GRAPH_EPOCHS = 2
#: the graph agreement: one epoch at level 2 of the wide MLP (the training
#: agreement's data), graph mode on the card against the fused tick on the
#: card and against graph mode on the CPU: equal index streams, n_err
#: within AGREE_N_ERR_TOL, every leaf within this share of its largest
#: element (the fused tick runs dense_layer/addmm and graph mode matmul:
#: the sums round in other orders)
GRAPH_LEAF_RTOL = 1e-4
#: the long-context stack in graph mode: 1 epoch (its K7 runs twice a
#: train minibatch a block: the forward unit's and the one GDSelfAttention
#: recomputes under autograd)
LONG_GRAPH_EPOCHS = 1
#: the Kohonen SOM: samples/som_digits.py's defaults (an (8, 8) grid,
#: minibatch 256) over the bench's 60000 x 784 pixels (uniform in [0, 1)),
#: 2 epochs. The card-CPU agreement runs one epoch in f32, each step of the
#: CPU from the card's weights before that step and its minibatch. On
#: uniform pixels every sample is nearly equidistant from the neurons: the
#: squared distances are ~100-260 and a sample's two nearest differ by as
#: little as 1.5e-5 (float64, measured on the CPU), below the f32
#: resolution of ||x||^2 - 2 x.w + ||w||^2 (~4e-4 over 784 terms), so a
#: winner may flip between two summation orders. Every winner whose
#: float64 top-2 gap exceeds SOM_TIE_GAP must be equal, and each step
#: whose winners all are equal must give new weights within
#: SOM_WEIGHT_RTOL of the largest
SOM_SHAPE, SOM_MINIBATCH, SOM_EPOCHS = (8, 8), 256, 2
SOM_TIE_GAP = 2e-3
SOM_WEIGHT_RTOL = 1e-4
#: MNIST784 through its idx loader: the bench data at MNIST's counts
#: (10000 test rows, the loader's validation, and 60000 train), pixels
#: times 255 as uint8 in four idx files (two gzipped), samples/
#: mnist784.py's configuration (784 -> 100 tanh -> 10, minibatch 100, lr
#: 0.03, moment 0.9), 3 epochs in the fused tick
MNIST_ROWS, MNIST_TEST, MNIST_EPOCHS, MNIST_MOMENT = 70000, 10000, 3, 0.9
MNIST_GZIPPED = ("train-labels-idx1-ubyte", "t10k-images-idx3-ubyte")
#: the wide MLP regressed (evaluator "mse", one-hot targets), 3 epochs;
#: its card-CPU agreement (level 2, one epoch, the training agreement's
#: rows): the losses differ in summation order only (~1e-6 relative) and
#: after three SGD steps every leaf lies within this share of its largest
MSE_EPOCHS, MSE_AGREE_RTOL = 3, 1e-4
#: the eight normalizers on the card against the CPU: float64 sums in
#: other orders, float32 outputs (~1e-7 relative)
NORMALIZER_NAMES = tuple(sorted(normalizer_registry))
NORM_RTOL = 1e-5
#: the file loaders: pickles of the bench data (4096 valid, 8192 train
#: rows) and 16 one-second 16-bit WAV tones at 16 kHz in two labels, in
#: windows of 1024 samples
PICKLE_VALID, PICKLE_TRAIN = 4096, 8192
SOUND_RATE, SOUND_WINDOW = 16000, 1024


def card_line():
    out = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit",
         "--format=csv,noheader"],
        check=True, capture_output=True, text=True, timeout=60).stdout
    return out.strip().splitlines()[0]


class Timer:
    """Median device time of one call, from CUDA events, with the L2
    cache flushed (a 256 MB write) before every timed launch."""

    def __init__(self, device, reps=25, warmup=3):
        self.flush = torch.empty(64 << 20, dtype=torch.float32,
                                 device=device)
        self.reps = reps
        self.warmup = warmup
        self.start = torch.cuda.Event(enable_timing=True)
        self.end = torch.cuda.Event(enable_timing=True)

    def __call__(self, fn):
        times = []
        for i in range(self.warmup + self.reps):
            self.flush.zero_()
            self.start.record()
            fn()
            self.end.record()
            self.end.synchronize()
            if i >= self.warmup:
                times.append(self.start.elapsed_time(self.end))
        return statistics.median(times)

    def kernel_ms(self, fn, name):
        """The median device time of the kernels whose name holds
        ``name`` among those ``fn`` launches, from torch.profiler, the L2
        flushed the same way: the kernel alone, without the launch and
        event overhead the CUDA-event reading carries."""
        from torch.profiler import ProfilerActivity, profile
        for _ in range(self.warmup):
            fn()
        with profile(activities=[ProfilerActivity.CUDA]) as prof:
            for _ in range(self.reps):
                self.flush.zero_()
                fn()
            torch.cuda.synchronize()
        times = [e.device_time for e in prof.events()
                 if e.device_type.name == "CUDA" and name in e.name]
        return 1e-3 * statistics.median(times)


def k1_problem(device, gen, lengths=K1_LENGTHS, heads=HEADS, head_dim=None,
               q_dtype=torch.bfloat16, kv_dtype=torch.bfloat16):
    """The serving path's K1 shapes: 8 slots, 16 heads of 64 (or
    ``heads`` heads of EMBED / heads, or of ``head_dim``), 128-token bf16
    pages (or ``kv_dtype``), ragged lengths from 0 to 1100 (0, a page
    boundary, a full table row), and a page table with one column more
    than the longest row needs, rows padded with the scratch page."""
    head_dim = head_dim or EMBED // heads
    pb = 1100 // PAGE + 2
    table = numpy.zeros((SLOTS, pb), numpy.int32)
    nxt = 1
    for s, n in enumerate(lengths):
        for p in range(n // PAGE + 1):
            table[s, p] = nxt
            nxt += 1
    shape = (nxt, PAGE, heads, head_dim)
    k = torch.randn(shape, generator=gen, device=device).to(kv_dtype)
    v = torch.randn(shape, generator=gen, device=device).to(kv_dtype)
    q = torch.randn((SLOTS, heads, head_dim), generator=gen,
                    device=device).to(q_dtype)
    return (q, k, v, torch.from_numpy(table).to(device),
            torch.tensor(lengths, dtype=torch.int32, device=device))


def paged_plan(label, table, lengths):
    """K1's plan (K3's too) at these operands, printed: the split, the
    grid and the blocks that find live positions."""
    pb = table.shape[1]
    pages, splits, _ = _paged_plan(SLOTS, HEADS, EMBED // HEADS, pb, PAGE,
                                   sm_count(table.device))
    span = pages * PAGE
    live = sum(-(-min(n + 1, pb * PAGE) // span) for n in lengths.tolist())
    print("%s plan, lengths %s: splits of %d page(s), %d a slot, %d blocks "
          "launched, %d with live positions"
          % (label, lengths.tolist(), pages, splits,
             HEADS * splits * SLOTS, HEADS * live))


def k1_check(args, label=""):
    """K1 against its plain version, and two calls bit for bit."""
    out = paged_attend(*args, page_size=PAGE)
    again = paged_attend(*args, page_size=PAGE)
    ref = _paged_attend_plain(*args, PAGE)
    torch.cuda.synchronize()
    err = (out - ref).abs().max().item()
    equal = torch.equal(out, again)
    print("K1 paged_attend%s, lengths %s: max_abs_err %.3g (tolerance "
          "%.1g), two calls bit-equal: %s" % (label, args[4].tolist(), err,
                                              K1_ATOL, equal))
    if not err <= K1_ATOL:
        raise AssertionError("K1 disagrees with its plain version")
    if not equal:
        raise AssertionError("K1's two calls differ")
    return err


def dtype_name(dtype):
    return str(dtype).split(".")[-1]


def k1_widths(device, gen):
    """C4, C5 and C6: K1 at every width of C4_WIDTHS, C5_WIDTHS and
    C6_WIDTHS, f32 and bf16 pools and queries, against its plain version
    and twice bit for bit; returns the largest error."""
    t0 = time.perf_counter()
    err = 0.0
    for head_dim in C4_WIDTHS + C5_WIDTHS + C6_WIDTHS:
        for kv_dtype in (torch.float32, torch.bfloat16):
            for q_dtype in (torch.float32, torch.bfloat16):
                args = k1_problem(device, gen, heads=C4_HEADS,
                                  head_dim=head_dim, q_dtype=q_dtype,
                                  kv_dtype=kv_dtype)
                err = max(err, k1_check(args, ", D = %d, q %s, pool %s"
                                        % (head_dim, dtype_name(q_dtype),
                                           dtype_name(kv_dtype))))
    widths = C4_WIDTHS + C5_WIDTHS + C6_WIDTHS
    print("K1 C4, C5 and C6 widths %s: %d calls checked in %.1f s, "
          "max_abs_err %.3g" % (list(widths), 4 * len(widths),
                                time.perf_counter() - t0, err))
    return err


def wide_time(timer, label, fn, name, nbytes, head_dim=C5_TIMED,
              tag="C5"):
    """C5 (C6): a kernel at D = C5_TIMED (C6_TIMED) in C4_HEADS heads (the
    burst's lengths): the event timer and the kernel alone beside the
    byte bound (each live byte read once, the output written once)."""
    ms = timer(fn)
    alone = timer.kernel_ms(fn, name)
    bound_ms = 1e3 * nbytes / HBM_BYTES_PER_S
    print("%s at D = %d (%s, %d heads, bf16 q): ms %.4f, alone %.4f, "
          "bound_ms %.4f (bytes, %d)" % (label, head_dim, tag, C4_HEADS, ms,
                                        alone, bound_ms, nbytes))
    return {"ms": ms, "kernel_ms": alone, "bound_ms": bound_ms}


def k1_wide_time(timer, device, gen, head_dim, tag):
    """K1 at ``head_dim`` in C4_HEADS heads, bf16 pool and q, timed."""
    wide = k1_problem(device, gen, heads=C4_HEADS, head_dim=head_dim)
    live = live_positions(wide[4], wide[3].shape[1])
    return wide_time(timer, "K1", lambda: paged_attend(*wide, page_size=PAGE),
                     "paged_attend", 2 * live * C4_HEADS * head_dim * 2
                     + SLOTS * C4_HEADS * head_dim * (2 + 4), head_dim, tag)


def live_positions(lengths, pb):
    return sum(min(int(n) + 1, pb * PAGE) for n in lengths.tolist())


def narrow_times(timer, label, fn, plain, name):
    """A kernel at the 48-wide serving shape (8 slots, 16 heads of 48,
    the burst's lengths): event timer, alone, and its plain version."""
    ms = timer(fn)
    alone = timer.kernel_ms(fn, name)
    plain_ms = timer(plain)
    print("%s at 16 heads of 48 (the tile path): ms %.4f, alone %.4f, "
          "plain_ms %.4f" % (label, ms, alone, plain_ms))


def k1_phase(timer, device, gen):
    q, k, v, table, lengths = k1_problem(device, gen)
    lopsided = k1_problem(device, gen, K1_LOPSIDED)
    for args in ((q, k, v, table, lengths), lopsided):
        paged_plan("K1", args[3], args[4])
    err = max(k1_check((q, k, v, table, lengths)), k1_check(lopsided),
              k1_widths(device, gen))
    narrow = k1_problem(device, gen, head_dim=NARROW_EMBED // NARROW_HEADS)
    narrow_times(timer, "K1", lambda: paged_attend(*narrow, page_size=PAGE),
                 lambda: _paged_attend_plain(*narrow, PAGE),
                 "paged_attend_kernel")
    c5 = k1_wide_time(timer, device, gen, C5_TIMED, "C5")
    c6 = k1_wide_time(timer, device, gen, C6_TIMED, "C6")
    # the library yardstick: SDPA over K/V already gathered contiguous
    # (the gather itself is not timed), with the same visibility mask
    span = table.shape[1] * PAGE
    idx = table.long()
    kg = k[idx].reshape(SLOTS, span, HEADS, -1).transpose(1, 2)
    vg = v[idx].reshape(SLOTS, span, HEADS, -1).transpose(1, 2)
    mask = (torch.arange(span, device=device)[None, :]
            <= lengths[:, None].long())[:, None, None, :]
    qs = q[:, :, None, :]
    sdpa = torch.nn.functional.scaled_dot_product_attention
    ms = timer(lambda: paged_attend(q, k, v, table, lengths,
                                    page_size=PAGE))
    lopsided_ms = timer(lambda: paged_attend(*lopsided, page_size=PAGE))
    kernel_ms = [timer.kernel_ms(lambda a=a: paged_attend(*a, page_size=PAGE),
                                 "paged_attend_kernel")
                 for a in ((q, k, v, table, lengths), lopsided)]
    plain_ms = timer(lambda: _paged_attend_plain(q, k, v, table, lengths,
                                                 PAGE))
    library_ms = timer(lambda: sdpa(qs, kg, vg, attn_mask=mask))
    live = sum(min(int(n) + 1, table.shape[1] * PAGE)
               for n in lengths.tolist())
    head_dim = EMBED // HEADS
    nbytes = (q.numel() * q.element_size()
              + 2 * live * HEADS * head_dim * k.element_size()
              + table.numel() * 4 + lengths.numel() * 4
              + SLOTS * HEADS * head_dim * 4)
    ops = 4 * live * HEADS * head_dim
    bound_ms = 1e3 * max(nbytes / HBM_BYTES_PER_S, ops / BF16_OPS_PER_S)
    bound_by = ("bytes" if nbytes / HBM_BYTES_PER_S
                >= ops / BF16_OPS_PER_S else "operations")
    print("K1 ms %.4f plain_ms %.4f sdpa_ms %.4f bound_ms %.4f (%s, %d "
          "live positions, %d bytes); lopsided lengths %s: %.4f ms; "
          "kernel alone (torch.profiler) %.4f and %.4f ms"
          % (ms, plain_ms, library_ms, bound_ms, bound_by, live, nbytes,
             list(K1_LOPSIDED), lopsided_ms, *kernel_ms))
    return {"name": "paged_attend", "route": "cuda",
            "source": "veles_tpu_torch/ops/csrc/paged_attention.cu",
            "replaces": "veles_tpu/ops/paged_attention.py:151",
            "max_abs_err": err, "ms": ms, "plain_ms": plain_ms,
            "bound_ms": bound_ms, "bound_by": bound_by,
            "library_ms": library_ms, "lopsided_ms": lopsided_ms,
            "kernel_ms": kernel_ms[0], "lopsided_kernel_ms": kernel_ms[1],
            "c5_ms": c5["ms"], "c5_kernel_ms": c5["kernel_ms"],
            "c5_bound_ms": c5["bound_ms"], "c6_ms": c6["ms"],
            "c6_kernel_ms": c6["kernel_ms"], "c6_bound_ms": c6["bound_ms"],
            "library": "scaled_dot_product_attention on the gathered pages"}


def k3_problem(device, gen, q_dtype, lengths=K1_LENGTHS, heads=HEADS,
               head_dim=None):
    """K1's smoke shapes in the int8-KV tier: the pool from
    ``_quantize_kv`` of random bf16 K/V, re-laid head-major (P, H, D,
    ps) with (P, H, ps) scales, and q pre-scaled by 1/sqrt(D)."""
    head_dim = head_dim or EMBED // heads
    q, k, v, table, lengths = k1_problem(device, gen, lengths, heads,
                                         head_dim)
    pool = []
    for val in (k, v):
        codes, scale = _quantize_kv(val)       # (P,ps,H,D), (P,ps,H)
        pool += [codes.permute(0, 2, 3, 1).contiguous(),
                 scale.permute(0, 2, 1).contiguous()]
    q = (q.float() * head_dim ** -0.5).to(q_dtype)
    return (q, *pool, table, lengths)


def k3_check(label, args):
    """K3 against its plain version, and two calls bit for bit."""
    out = paged_attend_int8(*args, page_size=PAGE)
    again = paged_attend_int8(*args, page_size=PAGE)
    ref = _paged_attend_int8_plain(*args, PAGE)
    torch.cuda.synchronize()
    err = (out - ref).abs().max().item()
    equal = torch.equal(out, again)
    print("K3 paged_attend_int8, %s, lengths %s: max_abs_err %.3g "
          "(tolerance %.0e), two calls bit-equal: %s"
          % (label, args[6].tolist(), err, K3_ATOL, equal))
    if not err <= K3_ATOL:
        raise AssertionError("K3 disagrees with its plain version (%s)"
                             % label)
    if not equal:
        raise AssertionError("K3's two calls differ (%s)" % label)
    return err


def k3_phase(timer, device, gen):
    """K3 against its plain version with bf16 and with f32 q, at the
    lopsided lengths and at the serving model's width in heads of 256
    (4 of them), each call twice bit for bit; timed at bf16 q (the
    serving path's) at the burst's and the lopsided lengths, beside SDPA
    over K/V dequantized and gathered beforehand (the gather and
    dequantization not timed)."""
    err = 0.0
    for q_dtype in (torch.float32, torch.bfloat16):
        args = k3_problem(device, gen, q_dtype)
        err = max(err, k3_check("q %s" % str(q_dtype).split(".")[-1], args))
    lopsided = k3_problem(device, gen, torch.bfloat16, K1_LOPSIDED)
    err = max(err, k3_check("q bfloat16", lopsided))
    err = max(err, k3_check("q bfloat16, D = 256", k3_problem(
        device, gen, torch.bfloat16, heads=EMBED // 256)))
    t0 = time.perf_counter()
    widths = C4_WIDTHS + C5_WIDTHS + C6_WIDTHS
    for head_dim in widths:     # C4, C5 and C6
        for q_dtype in (torch.float32, torch.bfloat16):
            err = max(err, k3_check(
                "q %s, D = %d" % (dtype_name(q_dtype), head_dim),
                k3_problem(device, gen, q_dtype, heads=C4_HEADS,
                           head_dim=head_dim)))
    print("K3 C4, C5 and C6 widths %s: %d calls checked in %.1f s"
          % (list(widths), 2 * len(widths), time.perf_counter() - t0))
    c5, c6 = [], []
    for head_dim, out in ((C5_TIMED, c5), (C6_TIMED, c6)):
        wide = k3_problem(device, gen, torch.bfloat16, heads=C4_HEADS,
                          head_dim=head_dim)
        live = live_positions(wide[6], wide[5].shape[1])
        out.append(wide_time(
            timer, "K3", lambda: paged_attend_int8(*wide, page_size=PAGE),
            "paged_attend_int8", 2 * live * C4_HEADS * (head_dim + 4)
            + SLOTS * C4_HEADS * head_dim * (2 + 4), head_dim,
            "C5" if head_dim == C5_TIMED else "C6"))
    (c5,), (c6,) = c5, c6
    narrow = k3_problem(device, gen, torch.bfloat16,
                        head_dim=NARROW_EMBED // NARROW_HEADS)
    narrow_times(timer, "K3",
                 lambda: paged_attend_int8(*narrow, page_size=PAGE),
                 lambda: _paged_attend_int8_plain(*narrow, PAGE),
                 "paged_attend_int8_kernel")
    for a in (args, lopsided):
        paged_plan("K3", a[5], a[6])
    q, kq, ks, vq, vs, table, lengths = args
    span = table.shape[1] * PAGE
    idx = table.long()

    def dequantized(codes, scale):
        full = codes.float() * scale[:, :, None, :]          # (P,H,D,ps)
        return full[idx].permute(0, 2, 1, 4, 3).reshape(
            SLOTS, HEADS, span, -1).to(q.dtype)

    kg, vg = dequantized(kq, ks), dequantized(vq, vs)
    mask = (torch.arange(span, device=device)[None, :]
            <= lengths[:, None].long())[:, None, None, :]
    qs = q[:, :, None, :]
    sdpa = torch.nn.functional.scaled_dot_product_attention
    ms = timer(lambda: paged_attend_int8(*args, page_size=PAGE))
    lopsided_ms = timer(lambda: paged_attend_int8(*lopsided,
                                                  page_size=PAGE))
    kernel_ms = [timer.kernel_ms(
        lambda a=a: paged_attend_int8(*a, page_size=PAGE),
        "paged_attend_int8_kernel") for a in (args, lopsided)]
    plain_ms = timer(lambda: _paged_attend_int8_plain(*args, PAGE))
    library_ms = timer(lambda: sdpa(qs, kg, vg, attn_mask=mask, scale=1.0))
    live = sum(min(int(n) + 1, span) for n in lengths.tolist())
    head_dim = EMBED // HEADS
    nbytes = (q.numel() * q.element_size()
              + 2 * live * HEADS * head_dim + 2 * live * HEADS * 4
              + table.numel() * 4 + lengths.numel() * 4
              + SLOTS * HEADS * head_dim * 4)
    ops = 4 * live * HEADS * head_dim
    bound_ms = 1e3 * max(nbytes / HBM_BYTES_PER_S, ops / BF16_OPS_PER_S)
    bound_by = ("bytes" if nbytes / HBM_BYTES_PER_S
                >= ops / BF16_OPS_PER_S else "operations")
    print("K3 ms %.4f plain_ms %.4f sdpa_ms %.4f bound_ms %.4f (%s, %d "
          "live positions, %d bytes); lopsided lengths %s: %.4f ms; "
          "kernel alone (torch.profiler) %.4f and %.4f ms"
          % (ms, plain_ms, library_ms, bound_ms, bound_by, live, nbytes,
             list(K1_LOPSIDED), lopsided_ms, *kernel_ms))
    return {"name": "paged_attend_int8", "route": "cuda",
            "source": "veles_tpu_torch/ops/csrc/paged_attention_int8.cu",
            "replaces": "veles_tpu/ops/paged_attention.py:201",
            "max_abs_err": err, "ms": ms, "plain_ms": plain_ms,
            "bound_ms": bound_ms, "bound_by": bound_by,
            "library_ms": library_ms, "lopsided_ms": lopsided_ms,
            "kernel_ms": kernel_ms[0], "lopsided_kernel_ms": kernel_ms[1],
            "c5_ms": c5["ms"], "c5_kernel_ms": c5["kernel_ms"],
            "c5_bound_ms": c5["bound_ms"], "c6_ms": c6["ms"],
            "c6_kernel_ms": c6["kernel_ms"], "c6_bound_ms": c6["bound_ms"],
            "library": "scaled_dot_product_attention on the dequantized "
                       "pages"}


def k4_problem(device, gen, q_dtype, width=K4_WIDTH, heads=HEADS,
               head_dim=None):
    """The dense int8-KV slab of the serving model at the dense phase's
    width: (8 slots, 16 heads, 64, width) codes and (8, 16, width)
    scales from ``_quantize_kv`` of random bf16 K/V, q (8, 1, 16, 64)
    pre-scaled by 1/sqrt(D) (or ``heads`` heads of ``head_dim``)."""
    head_dim = head_dim or EMBED // heads
    slab = []
    for _ in range(2):
        val = torch.randn((SLOTS, width, heads, head_dim), generator=gen,
                          device=device).to(torch.bfloat16)
        codes, scale = _quantize_kv(val)        # (S,T,H,D), (S,T,H)
        slab += [codes.permute(0, 2, 3, 1).contiguous(),
                 scale.permute(0, 2, 1).contiguous()]
    q = torch.randn((SLOTS, 1, heads, head_dim), generator=gen,
                    device=device) * head_dim ** -0.5
    return q.to(q_dtype), slab


def k4_widths(timer, device, gen):
    """C5 and C6: K4 at every width of C5_K4_WIDTHS and C6_K4_WIDTHS in
    C4_HEADS heads, f32 and bf16 q, the per-row mask, against its plain
    version and twice bit for bit; timed at C5_TIMED and C6_TIMED.
    Returns the largest error and the two timings."""
    t0 = time.perf_counter()
    err = 0.0
    mask = k4_masks(device, K4_WIDTH)["per-row"]
    for head_dim in C5_K4_WIDTHS + C6_K4_WIDTHS:
        for q_dtype in (torch.float32, torch.bfloat16):
            q, slab = k4_problem(device, gen, q_dtype, heads=C4_HEADS,
                                 head_dim=head_dim)
            out = int8_cache_attend(q, *slab, mask, use_pallas=True)
            again = int8_cache_attend(q, *slab, mask, use_pallas=True)
            ref = _cache_attend_plain(q, *slab, mask)
            torch.cuda.synchronize()
            e = (out - ref).abs().max().item()
            equal = torch.equal(out, again)
            print("K4 int8_cache_attend q %s, D = %d: max_abs_err %.3g "
                  "(tolerance %.0e), two calls bit-equal: %s"
                  % (dtype_name(q_dtype), head_dim, e, K4_ATOL, equal))
            if not e <= K4_ATOL or not equal:
                raise AssertionError("K4 fails at D = %d" % head_dim)
            err = max(err, e)
    widths = C5_K4_WIDTHS + C6_K4_WIDTHS
    print("K4 C5 and C6 widths %s: %d calls checked in %.1f s"
          % (list(widths), 2 * len(widths), time.perf_counter() - t0))
    timed = []
    for head_dim, tag in ((C5_TIMED, "C5"), (C6_TIMED, "C6")):
        q, slab = k4_problem(device, gen, torch.bfloat16, heads=C4_HEADS,
                             head_dim=head_dim)
        timed.append(wide_time(
            timer, "K4", lambda: int8_cache_attend(q, *slab, mask,
                                                   use_pallas=True),
            "cache_attend_int8", 2 * SLOTS * C4_HEADS * K4_WIDTH
            * (head_dim + 4) + mask.numel() * 4
            + SLOTS * C4_HEADS * head_dim * (2 + 4), head_dim, tag))
        del q, slab
    return err, timed[0], timed[1]


def k4_masks(device, t):
    """The slot step's per-row mask of K4_LENGTHS (clipped to t) and one
    shared mask."""
    pos = torch.arange(t, device=device)
    lengths = torch.tensor(K4_LENGTHS, device=device)
    per_row = torch.where(pos[None, :] <= lengths[:, None], 0.0, -1e30)
    shared = torch.where(pos <= 400, 0.0, -1e30)
    return {"per-row": per_row.float(), "shared": shared.float()}


def k4_phase(timer, device, gen):
    """K4 against its plain version with f32 and bf16 q, per-row and
    shared masks, and once on the slab cut to a 640-position span (a
    strided view, read in place); timed at bf16 q and the per-row mask
    (the serving path's), beside SDPA over K/V dequantized beforehand
    (the dequantization not timed)."""
    err = 0.0
    for q_dtype in (torch.float32, torch.bfloat16):
        q, slab = k4_problem(device, gen, q_dtype)
        for label, mask in k4_masks(device, K4_WIDTH).items():
            out = int8_cache_attend(q, *slab, mask, use_pallas=True)
            ref = _cache_attend_plain(q, *slab, mask)
            torch.cuda.synchronize()
            e = (out - ref).abs().max().item()
            print("K4 int8_cache_attend q %s, %s mask: max_abs_err %.3g "
                  "(tolerance %.0e)" % (str(q_dtype).split(".")[-1], label,
                                        e, K4_ATOL))
            err = max(err, e)
    view = [a[..., :K4_SPAN] for a in slab]
    mask = k4_masks(device, K4_SPAN)["per-row"]
    out = int8_cache_attend(q, *view, mask, use_pallas=True)
    ref = _cache_attend_plain(q, *(a.contiguous() for a in view), mask)
    torch.cuda.synchronize()
    e = (out - ref).abs().max().item()
    print("K4 on a %d-position span of the %d-wide slab (row stride %d): "
          "max_abs_err %.3g" % (K4_SPAN, K4_WIDTH, view[0].stride(2), e))
    err = max(err, e)
    if not err <= K4_ATOL:
        raise AssertionError("K4 disagrees with its plain version")
    wide_err, c5, c6 = k4_widths(timer, device, gen)
    err = max(err, wide_err)
    mask = k4_masks(device, K4_WIDTH)["per-row"]
    for t in (K4_WIDTH, K4_SPAN):
        splits, chunk = _attend_plan(SLOTS, HEADS, t, sm_count(device))
        print("K4 plan at %d positions: %d splits of %d positions, %d "
              "blocks" % (t, splits, chunk, SLOTS * HEADS * splits))
    first = int8_cache_attend(q, *slab, mask, use_pallas=True)
    again = int8_cache_attend(q, *slab, mask, use_pallas=True)
    torch.cuda.synchronize()
    print("K4 two calls bit-equal: %s" % torch.equal(first, again))
    if not torch.equal(first, again):
        raise AssertionError("K4's two calls differ")

    def dequantized(codes, scale):
        full = codes.float() * scale[:, :, None, :]          # (S,H,D,T)
        return full.transpose(2, 3).to(q.dtype)              # (S,H,T,D)

    kd, vd = dequantized(*slab[:2]), dequantized(*slab[2:])
    visible = (mask == 0)[:, None, None, :]
    qs = q.transpose(1, 2)                                   # (S,H,1,D)
    sdpa = torch.nn.functional.scaled_dot_product_attention
    ms = timer(lambda: int8_cache_attend(q, *slab, mask, use_pallas=True))
    kernel_ms = timer.kernel_ms(
        lambda: int8_cache_attend(q, *slab, mask, use_pallas=True),
        "cache_attend_int8_kernel")
    plain_ms = timer(lambda: _cache_attend_plain(q, *slab, mask))
    library_ms = timer(lambda: sdpa(qs, kd, vd, attn_mask=visible,
                                    scale=1.0))
    head_dim = EMBED // HEADS
    nbytes = (q.numel() * q.element_size()
              + 2 * SLOTS * HEADS * head_dim * K4_WIDTH
              + 2 * SLOTS * HEADS * K4_WIDTH * 4 + mask.numel() * 4
              + SLOTS * HEADS * head_dim * 4)
    ops = 4 * SLOTS * HEADS * head_dim * K4_WIDTH
    bound_ms = 1e3 * max(nbytes / HBM_BYTES_PER_S, ops / BF16_OPS_PER_S)
    bound_by = ("bytes" if nbytes / HBM_BYTES_PER_S
                >= ops / BF16_OPS_PER_S else "operations")
    print("K4 ms %.4f plain_ms %.4f sdpa_ms %.4f bound_ms %.4f (%s, %d "
          "positions a lane, %d bytes); kernel alone (torch.profiler) %.4f "
          "ms" % (ms, plain_ms, library_ms, bound_ms, bound_by, K4_WIDTH,
                  nbytes, kernel_ms))
    return {"name": "int8_cache_attend", "route": "cuda",
            "source": "veles_tpu_torch/ops/csrc/cache_attend_int8.cu",
            "replaces": "veles_tpu/ops/quant.py:161",
            "max_abs_err": err, "ms": ms, "plain_ms": plain_ms,
            "bound_ms": bound_ms, "bound_by": bound_by,
            "library_ms": library_ms, "kernel_ms": kernel_ms,
            "c5_ms": c5["ms"], "c5_kernel_ms": c5["kernel_ms"],
            "c5_bound_ms": c5["bound_ms"], "c6_ms": c6["ms"],
            "c6_kernel_ms": c6["kernel_ms"], "c6_bound_ms": c6["bound_ms"],
            "library": "scaled_dot_product_attention on the dequantized "
                       "slab"}


def gemm_bound(m, k, n, operand_bytes, out_bytes, ops_per_s, bias=False):
    """The least time of one (m, k, n) product: each operand read once,
    the output (and K6's f32 bias) written or read once, 2mkn operations
    at ``ops_per_s``."""
    nbytes = ((m * k + k * n) * operand_bytes + m * n * out_bytes
              + (4 * n if bias else 0))
    bytes_s, ops_s = nbytes / HBM_BYTES_PER_S, 2 * m * k * n / ops_per_s
    return 1e3 * max(bytes_s, ops_s), ("bytes" if bytes_s >= ops_s
                                       else "operations")


def gemm_operands(gen, device, shape, dtype, layout):
    """(a, b) of the (m, k, n) product laid out as the training path lays
    them: "forward" x (m, k) @ w (k, n), both row-major (K6);
    "weight_grad" x.T @ err, x.T a view of a row-major (k, m) x (K5);
    "grad_x" err @ w.T, w.T a view of a row-major (n, k) w (K5). Values
    are randn, b scaled by 1/sqrt(k) so outputs are of order 1."""
    m, k, n = shape
    if layout == "weight_grad":
        a = torch.randn((k, m), generator=gen, device=device).to(dtype).t()
    else:
        a = torch.randn((m, k), generator=gen, device=device).to(dtype)
    if layout == "grad_x":
        b = (torch.randn((n, k), generator=gen, device=device)
             / math.sqrt(k)).to(dtype).t()
    else:
        b = (torch.randn((k, n), generator=gen, device=device)
             / math.sqrt(k)).to(dtype)
    return a, b


def gemm_error(out, ref, tol):
    """Max abs error and that error relative to the largest output;
    raises past ``tol`` (relative)."""
    err = (out.float() - ref.float()).abs().max().item()
    rel = err / ref.float().abs().max().item()
    if not rel <= tol:
        raise AssertionError("max abs err %.3g is %.3g of the largest "
                             "output (tolerance %.0e)" % (err, rel, tol))
    return err, rel


def k5_phase(timer, device, gen):
    """K5 against its plain version at the weight-gradient shape (x.T
    read in place) and the grad_x shape (w.T read in place, written in
    x's type), bf16 and f32 operands; each timed against the plain
    version and cuBLAS through torch.matmul on the same operands (bf16
    out, widened to f32). The JSON numbers are the weight gradient's in
    bf16, the training path's."""
    worst = 0.0
    entry = None
    for layout, shape in (("weight_grad", K5_SHAPE),
                          ("grad_x", K5_GRAD_X_SHAPE)):
        for dtype in (torch.bfloat16, torch.float32):
            a, b = gemm_operands(gen, device, shape, dtype, layout)
            out_dtype = dtype if layout == "grad_x" else torch.float32
            out = blocked_matmul(a, b, out_dtype=out_dtype)
            ref = _blocked_matmul_plain(a, b, out_dtype)
            torch.cuda.synchronize()
            err, rel = gemm_error(out, ref, GEMM_BF16_RTOL
                                  if out_dtype == torch.bfloat16
                                  else GEMM_F32_RTOL)
            worst = max(worst, err)
            ms = timer(lambda: blocked_matmul(a, b, out_dtype=out_dtype))
            plain_ms = timer(lambda: _blocked_matmul_plain(a, b, out_dtype))
            library_ms = timer(lambda: torch.matmul(a, b).float())
            bf16 = dtype == torch.bfloat16
            bound_ms, bound_by = gemm_bound(
                *shape, a.element_size(), out.element_size(),
                BF16_OPS_PER_S if bf16 else F32_OPS_PER_S)
            print("K5 blocked_matmul %s (m %d, k %d, n %d) %s -> %s: "
                  "max_abs_err %.3g (%.3g relative) ms %.4f plain_ms %.4f "
                  "library_ms %.4f bound_ms %.4f (%s)"
                  % (layout, *shape, str(dtype).split(".")[-1],
                     str(out_dtype).split(".")[-1], err, rel, ms, plain_ms,
                     library_ms, bound_ms, bound_by))
            if layout == "weight_grad" and bf16:
                entry = {"ms": ms, "plain_ms": plain_ms,
                         "bound_ms": bound_ms, "bound_by": bound_by,
                         "library_ms": library_ms}
    return dict({"name": "blocked_matmul", "route": "cuda",
                 "source": "veles_tpu_torch/ops/csrc/gemm_sm90.cuh",
                 "replaces": "veles_tpu/ops/gemm.py:133",
                 "max_abs_err": worst, "library": "torch.matmul"}, **entry)


def k6_phase(timer, device, gen):
    """K6 against its plain version at the hidden layer's forward shape,
    bf16 and f32 operands, each of the five activations; tanh (the
    path's) timed against the plain version and torch.addmm plus the
    activation on the same operands. The JSON numbers are bf16's."""
    worst = 0.0
    entry = None
    for dtype in (torch.bfloat16, torch.float32):
        a, b = gemm_operands(gen, device, K6_SHAPE, dtype, "forward")
        bias = torch.randn(K6_SHAPE[2], generator=gen, device=device) * 0.1
        for activation in act_lib.ACTIVATIONS:
            out = dense_epilogue(a, b, bias, activation)
            ref = _dense_epilogue_plain(a, b, bias, activation)
            torch.cuda.synchronize()
            err, rel = gemm_error(out, ref, GEMM_F32_RTOL)
            worst = max(worst, err)
            print("K6 dense_epilogue %s %s: max_abs_err %.3g (%.3g "
                  "relative)" % (str(dtype).split(".")[-1], activation,
                                 err, rel))
        act = act_lib.ACTIVATIONS["tanh"][0]
        bias_lib = bias.to(dtype)
        ms = timer(lambda: dense_epilogue(a, b, bias, "tanh"))
        plain_ms = timer(lambda: _dense_epilogue_plain(a, b, bias, "tanh"))
        library_ms = timer(lambda: act(torch.addmm(bias_lib, a, b).float()))
        bf16 = dtype == torch.bfloat16
        bound_ms, bound_by = gemm_bound(
            *K6_SHAPE, a.element_size(), 4,
            BF16_OPS_PER_S if bf16 else F32_OPS_PER_S, bias=True)
        print("K6 dense_epilogue tanh (m %d, k %d, n %d) %s: ms %.4f "
              "plain_ms %.4f library_ms %.4f bound_ms %.4f (%s)"
              % (*K6_SHAPE, str(dtype).split(".")[-1], ms, plain_ms,
                 library_ms, bound_ms, bound_by))
        if bf16:
            entry = {"ms": ms, "plain_ms": plain_ms, "bound_ms": bound_ms,
                     "bound_by": bound_by, "library_ms": library_ms}
    # AlexNet's 1000-way head at minibatch 512 with the knobs on (its
    # forward runs linear; relu as the issue of this shape asks)
    a, b = gemm_operands(gen, device, K6_ALEX_SHAPE, torch.bfloat16,
                         "forward")
    bias = torch.randn(K6_ALEX_SHAPE[2], generator=gen, device=device) * 0.1
    for activation in ("relu", "linear"):
        out = dense_epilogue(a, b, bias, activation)
        ref = _dense_epilogue_plain(a, b, bias, activation)
        torch.cuda.synchronize()
        err, rel = gemm_error(out, ref, GEMM_F32_RTOL)
        worst = max(worst, err)
        print("K6 dense_epilogue bfloat16 %s (m %d, k %d, n %d): "
              "max_abs_err %.3g (%.3g relative)"
              % (activation, *K6_ALEX_SHAPE, err, rel))
    ms = timer(lambda: dense_epilogue(a, b, bias, "relu"))
    plain_ms = timer(lambda: _dense_epilogue_plain(a, b, bias, "relu"))
    bound_ms, bound_by = gemm_bound(*K6_ALEX_SHAPE, 2, 4, BF16_OPS_PER_S,
                                    bias=True)
    print("K6 dense_epilogue relu (m %d, k %d, n %d) bfloat16: ms %.4f "
          "plain_ms %.4f bound_ms %.4f (%s)"
          % (*K6_ALEX_SHAPE, ms, plain_ms, bound_ms, bound_by))
    return dict({"name": "dense_epilogue", "route": "cuda",
                 "source": "veles_tpu_torch/ops/csrc/gemm_sm90.cuh",
                 "replaces": "veles_tpu/ops/gemm.py:199",
                 "max_abs_err": worst, "library": "torch.addmm, then the "
                                                  "activation"}, **entry)


def library_available(x, q_t, scale_t):
    """Whether this PyTorch build runs its W8A16 operator
    (``torch._weight_int8pack_mm``) on the card: the yardstick, never
    called by the port."""
    try:
        torch._weight_int8pack_mm(x, q_t, scale_t)
        torch.cuda.synchronize()
        return True
    except (AttributeError, RuntimeError, NotImplementedError) as exc:
        print("K2 library yardstick unavailable: %s"
              % str(exc).splitlines()[0])
        return False


def k2_step_graph_ms(timer, problems):
    """One decode step's K2 launches (``problems``: (x, q, scale) in the
    step's order) captured in a CUDA graph and replayed: the card's time
    for the step's products back to back, without the host's launch gap
    or the per-call event overhead that single-call timings each pay."""
    stream = torch.cuda.Stream()
    with torch.cuda.stream(stream):  # the capture stream's scratch, sized
        for problem in problems:
            int8_matmul(*problem)
    torch.cuda.synchronize()
    graph = torch.cuda.CUDAGraph()
    with torch.cuda.graph(graph, stream=stream):
        for problem in problems:
            int8_matmul(*problem)
    graph.replay()
    torch.cuda.synchronize()
    return timer(graph.replay)


def k2_phase(timer, device, gen):
    """Every M in {8, 100, 256} at every weight shape of the decode
    step, bf16 x, each against its plain version and run twice, bit for
    bit (the split-K partials meet in a fixed order); the JSON numbers
    are one decode step's worth at M = 8 (each shape's time times its
    launches per step), and ``step_graph_ms`` the step's 17 launches
    replayed back to back from a CUDA graph."""
    worst_rel, worst_abs = 0.0, 0.0
    step = {"ms": 0.0, "plain_ms": 0.0, "library_ms": 0.0,
            "bytes_s": 0.0, "ops_s": 0.0}
    library = None
    decode = []  # the M = 8 problems, one a weight shape
    for (k, n), per_step in zip(K2_SHAPES, K2_PER_STEP):
        w = torch.randn((k, n), generator=gen, device=device) / math.sqrt(k)
        q, scale = quantize_int8(w)
        # the library yardstick's layout: (N, K) weights, scales in x's
        # type
        q_t = q.t().contiguous()
        scale_t = scale.to(torch.bfloat16)
        for m in (8, 100, 256):
            x = torch.randn((m, k), generator=gen,
                            device=device).to(torch.bfloat16)
            out = int8_matmul(x, q, scale)
            again = int8_matmul(x, q, scale)
            ref = _int8_matmul_plain(x, q, scale)
            torch.cuda.synchronize()
            if not torch.equal(out, again):
                raise AssertionError("K2 M=%d K=%d N=%d: two calls differ"
                                     % (m, k, n))
            diff = (out.float() - ref.float()).abs().max().item()
            rel = diff / ref.float().abs().max().item()
            worst_abs = max(worst_abs, diff)
            worst_rel = max(worst_rel, rel)
            if library is None:
                library = library_available(x, q_t, scale_t)
            ms = timer(lambda: int8_matmul(x, q, scale))
            plain_ms = timer(lambda: _int8_matmul_plain(x, q, scale))
            library_ms = (timer(lambda: torch._weight_int8pack_mm(
                x, q_t, scale_t)) if library else None)
            nbytes = m * k * 2 + k * n + n * 4 + m * n * 2
            ops = 2 * m * k * n
            bytes_s = nbytes / HBM_BYTES_PER_S
            ops_s = ops / BF16_OPS_PER_S
            print("K2 int8_matmul M=%d K=%d N=%d: rel_err %.3g abs_err "
                  "%.3g, two calls bit-equal; ms %.4f plain_ms %.4f "
                  "library_ms %s bound_ms %.4f (%s)"
                  % (m, k, n, rel, diff, ms, plain_ms,
                     "%.4f" % library_ms if library_ms is not None
                     else "null", 1e3 * max(bytes_s, ops_s),
                     "bytes" if bytes_s >= ops_s else "operations"))
            if m == 8:
                decode.append((x, q, scale))
                step["ms"] += per_step * ms
                step["plain_ms"] += per_step * plain_ms
                if library:
                    step["library_ms"] += per_step * library_ms
                step["bytes_s"] += per_step * bytes_s
                step["ops_s"] += per_step * ops_s
    print("K2 worst rel_err %.3g (tolerance %.0e relative to the largest "
          "output)" % (worst_rel, K2_RTOL))
    if not worst_rel <= K2_RTOL:
        raise AssertionError("K2 disagrees with its plain version")
    # what a single timed call pays beyond its kernel's work: one
    # one-element kernel under the same timer
    tiny = torch.zeros(1, device=device)
    floor_ms = timer(lambda: tiny.add_(1))
    # the step's order: the four block projections of each block, then
    # the vocab head
    graph_ms = k2_step_graph_ms(
        timer, [p for _ in range(BLOCKS) for p in decode[:4]] + decode[4:])
    print("K2 one decode step at M=8: %.4f ms as the sum of single calls, "
          "%.4f ms replayed from a CUDA graph (17 launches back to back); "
          "a one-element kernel reads %.4f ms under the same timer"
          % (step["ms"], graph_ms, floor_ms))
    bound_s = max(step["bytes_s"], step["ops_s"])
    return {"name": "int8_matmul", "route": "cuda",
            "source": "veles_tpu_torch/ops/csrc/int8_matmul.cu",
            "replaces": "veles_tpu/ops/quant.py:63",
            "max_abs_err": worst_abs, "ms": step["ms"],
            "plain_ms": step["plain_ms"], "bound_ms": 1e3 * bound_s,
            "bound_by": ("bytes" if step["bytes_s"] >= step["ops_s"]
                         else "operations"),
            "library_ms": step["library_ms"] if library else None,
            "library": "torch._weight_int8pack_mm" if library else None,
            "step_graph_ms": graph_ms}


def post(port, tokens, n_tokens, timeout=600):
    req = urllib.request.Request(
        "http://127.0.0.1:%d/generate" % port,
        data=json.dumps({"tokens": tokens, "n_tokens": n_tokens}).encode(),
        headers={"Content-Type": "application/json"})
    with urllib.request.urlopen(req, timeout=timeout) as resp:
        return json.loads(resp.read().decode())["tokens"]


#: every kernel's launch counter, by the name the JSON line gives it
COUNTERS = {"paged_attend": paged_attend, "int8_matmul": int8_matmul,
            "paged_attend_int8": paged_attend_int8,
            "int8_cache_attend": int8_cache_attend,
            "blocked_matmul": blocked_matmul,
            "dense_epilogue": dense_epilogue,
            "flash_attention_fwd": flash_attention_fwd,
            "flash_attention_dkv": flash_attention_dkv,
            "flash_attention_dq": flash_attention_dq}
#: the attention kernels among them
ATTENTION = ("paged_attend", "paged_attend_int8", "int8_cache_attend",
             "flash_attention_fwd")
#: the flash kernels
FLASH = ("flash_attention_fwd", "flash_attention_dkv", "flash_attention_dq")


def counts():
    return {name: fn.launches for name, fn in COUNTERS.items()}


def burst(port, prompts, n_tokens=N_TOKENS):
    """POST every prompt at once; returns the streams in order."""
    streams = [None] * len(prompts)
    errors = []

    def client(i):
        try:
            streams[i] = post(port, prompts[i], n_tokens)
        except Exception as exc:  # reported below, fails the phase
            errors.append("request %d: %r" % (i, exc))

    threads = [threading.Thread(target=client, args=(i,))
               for i in range(len(prompts))]
    for thread in threads:
        thread.start()
    for thread in threads:
        thread.join(timeout=900)
    if errors or any(thread.is_alive() for thread in threads):
        raise AssertionError("serving failed: %s" % errors)
    for stream in streams:
        if len(stream) != n_tokens or not all(0 <= t < VOCAB
                                              for t in stream):
            raise AssertionError("bad stream: %r" % (stream,))
    return streams


def serve(params, table, waves, quantize, device, paged=True, heads=HEADS,
          max_len=MAX_LEN, slots=SLOTS, n_tokens=N_TOKENS):
    """Answer ``waves`` of prompts through a fresh GenerateAPI over HTTP
    (on the paged pool, or with ``paged=False`` the dense slab), each
    wave posted at once after the previous one completed. A short
    warm-up request runs first; every launch counter is zeroed after it
    and read after the last wave. Returns the streams, the wall seconds,
    the launches, the chunks, the host-blocking seconds (dispatch +
    collect, and admission), /healthz before and after the waves and the
    (stopped) API, by name."""
    api = GenerateAPI(params, table, heads, slots=slots, max_len=max_len,
                      n_tokens=n_tokens, chunk=CHUNK, paged=paged,
                      page_size=PAGE, quantize=quantize,
                      device=device).start()
    try:
        # shorter than a page: never published to the prefix cache
        post(api.port, waves[0][0][:min(16, PAGE - 1)], CHUNK)
        torch.cuda.synchronize()
        health0 = api.health.snapshot()
        timings0 = dict(api.decoder.timings)
        for fn in COUNTERS.values():
            fn.launches = 0
        t0 = time.perf_counter()
        streams = [stream for wave in waves
                   for stream in burst(api.port, wave, n_tokens)]
        wall = time.perf_counter() - t0
        launches = counts()
        health = api.health.snapshot()
        chunks = (health["dispatch_counts"]["chunk"]
                  - health0["dispatch_counts"]["chunk"])
        host_s = sum(api.decoder.timings[key] - timings0[key]
                     for key in ("dispatch_s", "collect_s"))
        admit_s = api.decoder.timings["admit_s"] - timings0["admit_s"]
        return {"streams": streams, "wall": wall, "launches": launches,
                "chunks": chunks, "host_s": host_s, "admit_s": admit_s,
                "health0": health0, "health": health, "api": api}
    finally:
        api.stop()


def bf16_model(device):
    rng = numpy.random.RandomState(0)
    params = init_transformer_params(rng, BLOCKS, EMBED, HEADS, VOCAB,
                                     dtype=torch.bfloat16, device=device)
    table = torch.from_numpy(
        rng.randn(VOCAB, EMBED).astype(numpy.float32) * 0.02).to(
            device=device, dtype=torch.bfloat16)
    return params, table


def serving_phase(device, prompts):
    """The burst of ``prompts`` in the float, int8 and int8-KV tiers;
    each run must go through its kernels: K1 (or K3 in the int8-KV tier,
    where K1 must not launch) once per block and step, K2 in both int8
    tiers."""
    params, table = bf16_model(device)
    launches = dict.fromkeys(COUNTERS, 0)
    for quantize in (None, "int8", "int8-kv"):
        run = serve(params, table, [prompts], quantize, device)
        got, chunks = run["launches"], run["chunks"]
        steps = chunks * CHUNK
        attend = "paged_attend_int8" if quantize == "int8-kv" \
            else "paged_attend"
        print("serve %s bf16: %d requests x %d tokens in %.3f s = %.1f "
              "tokens/s; %d chunks of %d, %.3f host-blocking ms per chunk "
              "(dispatch + collect); launches K1 %d, K2 %d, K3 %d (%s >= "
              "%d blocks x %d steps); KV pool %d bytes"
              % (quantize or "float", len(prompts), N_TOKENS, run["wall"],
                 len(prompts) * N_TOKENS / run["wall"], chunks, CHUNK,
                 1e3 * run["host_s"] / max(chunks, 1),
                 got["paged_attend"], got["int8_matmul"],
                 got["paged_attend_int8"], attend, BLOCKS, steps,
                 paged_kv_bytes(run["api"].decoder.state)))
        if got[attend] < BLOCKS * steps or steps == 0:
            raise AssertionError("%s launches %d < %d blocks x %d steps"
                                 % (attend, got[attend], BLOCKS, steps))
        if quantize == "int8-kv" and got["paged_attend"]:
            raise AssertionError("the int8-KV run launched K1")
        if got["int8_cache_attend"]:
            raise AssertionError("the paged run launched K4")
        if quantize and got["int8_matmul"] < sum(K2_PER_STEP) * steps:
            raise AssertionError("the %s run launched K2 %d < %d per step "
                                 "x %d steps" % (quantize,
                                                 got["int8_matmul"],
                                                 sum(K2_PER_STEP), steps))
        for name, n in got.items():
            launches[name] += n
    return launches


def prefix_waves(rng):
    """The repo's shared-prompt mix (bench.py:1237-1281): a 256-token
    system prompt (two pages), then eight distinct tails of 24 + 8 i
    tokens behind it at once, then the system prompt twice more."""
    system = rng.randint(0, VOCAB, 2 * PAGE).tolist()
    tails = [system + rng.randint(0, VOCAB, 24 + 8 * i).tolist()
             for i in range(8)]
    return [[system], tails, [system], [system]]


def check_prefix_counts(health0, health):
    """One cold admission (the system prompt), eight tails and two
    hits: 10 prefix hits and 1 miss between the two /healthz reads."""
    def delta(section, key):
        return health[section][key] - health0[section][key]

    got = {"prefix_hits": delta("pool", "prefix_hits"),
           "prefix_misses": delta("pool", "prefix_misses"),
           "admit_tail": delta("dispatch_counts", "admit_tail"),
           "admit_hit": delta("dispatch_counts", "admit_hit")}
    if got["prefix_hits"] != 10 or got["prefix_misses"] != 1 \
            or got["admit_tail"] < 1 or got["admit_hit"] < 1:
        raise AssertionError("prefix traffic admitted %s, expected 10 "
                             "hits, 1 miss, >= 1 tail and >= 1 hit "
                             "dispatch" % got)
    return got


def admit_ms(dec, prompt):
    """Host-blocking ms of the admission of ``prompt``: the change in
    the decoder's ``timings["admit_s"]`` across the step that admits it
    (``bench.py:1241-1248``), the card idle before it."""
    rid = dec.submit(prompt, 1)
    torch.cuda.synchronize()
    before = dec.timings["admit_s"]
    dec.step()
    ms = 1e3 * (dec.timings["admit_s"] - before)
    dec.run_until_drained()
    dec.results.pop(rid, None)
    return ms


def prefix_phase(device, rng):
    """The shared-prompt traffic in the bf16 float tier through
    GenerateAPI; then, on the same (stopped) decoder, three fresh
    two-page prompts admitted cold and then again as hits."""
    params, table = bf16_model(device)
    waves = prefix_waves(rng)
    run = serve(params, table, waves, None, device)
    counted = check_prefix_counts(run["health0"], run["health"])
    got = run["launches"]
    requests = sum(len(wave) for wave in waves)
    print("prefix traffic bf16: %d requests x %d tokens in %.3f s = %.1f "
          "tokens/s, %d chunks; %s; launches K1 %d, K2 %d, K3 %d"
          % (requests, N_TOKENS, run["wall"],
             requests * N_TOKENS / run["wall"], run["chunks"], counted,
             got["paged_attend"], got["int8_matmul"],
             got["paged_attend_int8"]))
    if got["paged_attend"] == 0:
        raise AssertionError("the prefix traffic never launched K1")
    fresh = [rng.randint(0, VOCAB, 2 * PAGE) for _ in range(3)]
    dec = run["api"].decoder
    cold = [admit_ms(dec, prompt) for prompt in fresh]
    hits = dict(dec.dispatch_counts)
    hit = [admit_ms(dec, prompt) for prompt in fresh]
    if dec.dispatch_counts["admit_hit"] - hits["admit_hit"] != 3:
        raise AssertionError("the re-admitted prompts were not hits")
    print("admission of a %d-token prompt (host-blocking ms, admit_s, "
          "min of 3): cold %.3f, hit %.3f"
          % (2 * PAGE, min(cold), min(hit)))
    return got


def dense_run(params, table, prompts, quantize, device):
    """One drain of ``prompts`` through a fresh ContinuousDecoder on the
    dense slab with decode_continuous's stagger: the first SLOTS up
    front, then one more each lag-1 pass. Returns the decoder and the
    wall seconds of the drain, the card synchronised at both ends."""
    dec = ContinuousDecoder(params, table, HEADS, slots=SLOTS,
                            max_len=DENSE_MAX_LEN, n_tokens=DENSE_BUDGET,
                            quantize=quantize, device=device)
    pending = list(prompts)
    for _ in range(min(SLOTS, len(pending))):
        dec.submit(pending.pop())

    def admit():
        if pending:
            dec.submit(pending.pop())

    torch.cuda.synchronize()
    t0 = time.perf_counter()
    dec.drain_pipelined(DENSE_CHUNK, admit=admit)
    torch.cuda.synchronize()
    return dec, time.perf_counter() - t0


def dense_phase(device):
    """decode_continuous's traffic on the dense slot slab in the float,
    int8 and int8-KV tiers: a warm run, then the counters zeroed and a
    measured run. The int8-KV run must launch K4 once per block and
    step and neither paged kernel, both int8 runs K2, the float run no
    attention kernel."""
    params, table = bf16_model(device)
    rng = numpy.random.RandomState(0)
    prompts = [rng.randint(0, VOCAB, DENSE_PROMPT)
               for _ in range(DENSE_REQUESTS)]
    launches = dict.fromkeys(COUNTERS, 0)
    for quantize in (None, "int8", "int8-kv"):
        dense_run(params, table, prompts, quantize, device)
        for fn in COUNTERS.values():
            fn.launches = 0
        dec, wall = dense_run(params, table, prompts, quantize, device)
        got = counts()
        steps = dec.dispatch_counts["chunk"] * DENSE_CHUNK
        timings = {key: round(1e3 * sec, 3)
                   for key, sec in dec.timings.items()}
        print("dense slab %s bf16: %d requests x %d tokens in %.3f s = %.1f "
              "tokens/s; host-blocking ms %s; dispatch_counts %s; max_len "
              "%d, slab K/V %d bytes, state %d bytes; launches %s"
              % (quantize or "float", DENSE_REQUESTS, DENSE_BUDGET, wall,
                 dec.tokens_out / wall, timings, dec.dispatch_counts,
                 dec.max_len, paged_kv_bytes(dec.state),
                 slot_state_bytes(dec.state), got))
        if dec.tokens_out != DENSE_REQUESTS * DENSE_BUDGET or any(
                len(stream) != DENSE_BUDGET
                or not all(0 <= t < VOCAB for t in stream)
                for stream in dec.results.values()):
            raise AssertionError("the dense %s run delivered %d tokens"
                                 % (quantize or "float", dec.tokens_out))
        if quantize == "int8-kv":
            if got["int8_cache_attend"] < BLOCKS * steps or steps == 0:
                raise AssertionError("K4 launched %d < %d blocks x %d "
                                     "steps" % (got["int8_cache_attend"],
                                                BLOCKS, steps))
            if got["paged_attend"] or got["paged_attend_int8"]:
                raise AssertionError("the dense int8-KV run launched a "
                                     "paged kernel")
        elif any(got[name] for name in ATTENTION):
            raise AssertionError("the dense %s run launched an attention "
                                 "kernel" % (quantize or "float"))
        if bool(quantize) != bool(got["int8_matmul"]):
            raise AssertionError("the dense %s run launched K2 %d times"
                                 % (quantize or "float",
                                    got["int8_matmul"]))
        for name, n in got.items():
            launches[name] += n
    return launches


def agreement_phase(device, prompts, waves):
    """float32 serving against the dense reference decode, on the paged
    pool and then on the dense slab (GenerateAPI with paged=False): float
    weights against generate() on the card (plain ops: no kernel may
    launch), int8 and int8-KV against generate() on the CPU (plain
    versions everywhere), and the shared-prompt traffic against
    generate() on the card. Each reference is decoded once and compared
    with every run of its tier."""
    rng = numpy.random.RandomState(0)
    params = init_transformer_params(rng, BLOCKS, EMBED, HEADS, VOCAB,
                                     device="cpu")
    table = torch.from_numpy(
        rng.randn(VOCAB, EMBED).astype(numpy.float32) * 0.02)
    runs = [("float", None, [prompts], True),
            ("int8", "int8", [prompts], True),
            ("int8-kv", "int8-kv", [prompts], True),
            ("prefix", None, waves, True),
            ("dense float", None, [prompts], False),
            ("dense int8", "int8", [prompts], False),
            ("dense int8-kv", "int8-kv", [prompts], False)]
    quantized = quantize_params(params)
    refs = {}
    for label, quantize, run_waves, paged in runs:
        tier = params if quantize is None else quantized
        run = serve(tier, table, run_waves, quantize, device, paged=paged)
        if label == "prefix":
            check_prefix_counts(run["health0"], run["health"])
        if paged != ("pool" in run["health"]):
            raise AssertionError("the %s run served the wrong KV tier"
                                 % label)
        compare_streams(label, tier, table, HEADS, quantize,
                        device if quantize is None else "cpu",
                        [p for wave in run_waves for p in wave],
                        run["streams"], refs)


def compare_streams(label, tier, table, heads, quantize, ref_device,
                    prompts, streams, refs, n_tokens=N_TOKENS):
    """Each stream against the dense reference decode (``generate``, which
    must launch no kernel) of its prompt, up to the first step where the
    reference's top-2 logit gap is below TOP2_GAP; ``refs`` caches the
    references by (tier, prompt)."""
    compared = cut = 0
    for prompt, stream in zip(prompts, streams):
        key = (quantize, tuple(prompt))
        if key not in refs:
            before = counts()
            ref, _, logits = generate(
                tier, table, numpy.asarray(prompt)[None], heads, n_tokens,
                return_logits=True, quantize=quantize, device=ref_device)
            if counts() != before:
                raise AssertionError("the reference decode launched a "
                                     "kernel")
            top2 = torch.topk(logits[0], 2, dim=-1).values
            gaps = (top2[:, 0] - top2[:, 1]).tolist()
            n = next((i for i, g in enumerate(gaps) if g < TOP2_GAP),
                     len(gaps))
            refs[key] = (ref[0, :n].tolist(), len(gaps) - n)
        want, skipped = refs[key]
        if stream[:len(want)] != want:
            raise AssertionError(
                "%s stream disagrees with the reference: %r vs %r"
                % (label, stream[:len(want)], want))
        compared += len(want)
        cut += skipped
    print("agreement %s f32: %d steps compared, %d steps cut off at a "
          "reference top-2 gap below %.0e" % (label, compared, cut,
                                              TOP2_GAP))
    return compared


def narrow_heads_phase(device, prompts):
    """C4 on the serving path: the serving model's depth and vocabulary at
    embed 768 in 16 heads of 48 (head rows of 96 bf16 bytes; f32 here, so
    192), f32 weights, the paged pool in the float (K1) and int8-KV (K3)
    tiers, 8 requests x 16 tokens; each stream against the dense
    reference decode (on the card for float, the CPU for int8-KV) in
    every compared step."""
    t0 = time.perf_counter()
    rng = numpy.random.RandomState(3)
    params = init_transformer_params(rng, BLOCKS, NARROW_EMBED,
                                     NARROW_HEADS, VOCAB, device="cpu")
    table = torch.from_numpy(
        rng.randn(VOCAB, NARROW_EMBED).astype(numpy.float32) * 0.02)
    refs = {}
    for quantize, attend in ((None, "paged_attend"),
                             ("int8-kv", "paged_attend_int8")):
        tier = params if quantize is None else quantize_params(params)
        run = serve(tier, table, [prompts], quantize, device,
                    heads=NARROW_HEADS, n_tokens=NARROW_TOKENS)
        got = run["launches"][attend]
        print("serve %s f32, heads of %d: %d requests x %d tokens in %.3f "
              "s, %s launches %d" % (quantize or "float",
                                     NARROW_EMBED // NARROW_HEADS,
                                     len(prompts), NARROW_TOKENS,
                                     run["wall"], attend, got))
        if not got:
            raise AssertionError("the 48-wide %s run launched no %s"
                                 % (quantize or "float", attend))
        compare_streams("heads of 48, %s" % (quantize or "float"), tier,
                        table, NARROW_HEADS, quantize,
                        device if quantize is None else "cpu", prompts,
                        run["streams"], refs, NARROW_TOKENS)
    print("heads-of-48 serving phase: %.1f s" % (time.perf_counter() - t0))


def sampling_phase(device, prompts):
    """Per-request sampling streams on the card: ``prompts`` (8 requests)
    sampled at once through ContinuousDecoder on the dense slab at the
    serving model's width (float32 weights, SAMPLE_TEMPERATURE and
    SAMPLE_TOP_K, seed SAMPLE_SEED); then each request alone (the
    requests before it submitted and cancelled before any step, so it
    keeps its id and its key and takes another slot): its stream must
    equal its stream in the burst, and generate(batch=1,
    key=request_key(seed, request id)) on the card."""
    rng = numpy.random.RandomState(0)
    params = init_transformer_params(rng, BLOCKS, EMBED, HEADS, VOCAB,
                                     device=device)
    table = torch.from_numpy(
        rng.randn(VOCAB, EMBED).astype(numpy.float32) * 0.02).to(device)

    def decoder():
        return ContinuousDecoder(
            params, table, HEADS, slots=SLOTS, max_len=MAX_LEN,
            n_tokens=N_TOKENS, temperature=SAMPLE_TEMPERATURE,
            top_k=SAMPLE_TOP_K, seed=SAMPLE_SEED, device=device)

    dec = decoder()
    dec.submit(prompts[0][:16], CHUNK)  # warm-up, its own request id 0
    dec.drain_pipelined(CHUNK)
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    rids = [dec.submit(p) for p in prompts]
    dec.drain_pipelined(CHUNK)
    torch.cuda.synchronize()
    wall = time.perf_counter() - t0
    streams = [dec.results[rid] for rid in rids]
    if any(len(s) != N_TOKENS or not all(0 <= t < VOCAB for t in s)
           for s in streams) or len({tuple(s) for s in streams}) < 2:
        raise AssertionError("bad sampled streams: %r" % (streams,))
    for rid, prompt, stream in zip(rids, prompts, streams):
        alone = decoder()
        for _ in range(rid):
            alone.cancel(alone.submit(prompt))
        got = alone.submit(prompt)
        alone.drain_pipelined(CHUNK)
        if alone.results[got] != stream:
            raise AssertionError(
                "request %d sampled %r alone and %r in the burst"
                % (rid, alone.results[got], stream))
        ref, _ = generate(params, table, numpy.asarray(prompt)[None],
                          HEADS, N_TOKENS, temperature=SAMPLE_TEMPERATURE,
                          top_k=SAMPLE_TOP_K,
                          key=request_key(SAMPLE_SEED, rid), device=device)
        if ref[0].tolist() != stream:
            raise AssertionError(
                "request %d sampled %r in the burst, generate(key=) %r"
                % (rid, stream, ref[0].tolist()))
    print("sampling: %d requests x %d tokens at temperature %g, top-k %d, "
          "f32: %.1f tokens/s in the burst; every stream equal alone (its "
          "own id, another slot) and to generate(batch=1, key=)"
          % (len(prompts), N_TOKENS, SAMPLE_TEMPERATURE, SAMPLE_TOP_K,
             len(prompts) * N_TOKENS / wall))
    # the same burst through HTTP, temperature and top-k on the API: the
    # requests are posted in order (each staged before the next is sent,
    # so request i takes id i + 1 after the warm-up's 0) and all in
    # flight together; each stream must be the decoder's for its id
    api = GenerateAPI(params, table, HEADS, slots=SLOTS, max_len=MAX_LEN,
                      n_tokens=N_TOKENS, chunk=CHUNK,
                      temperature=SAMPLE_TEMPERATURE, top_k=SAMPLE_TOP_K,
                      seed=SAMPLE_SEED, paged=False, device=device).start()
    try:
        post(api.port, prompts[0][:16], CHUNK)
        answers = [None] * len(prompts)

        def client(i):
            answers[i] = post(api.port, prompts[i], N_TOKENS)

        threads = []
        for i in range(len(prompts)):
            threads.append(threading.Thread(target=client, args=(i,)))
            threads[-1].start()
            while api.decoder._next_id < i + 2:
                time.sleep(0.001)
        for thread in threads:
            thread.join(timeout=600)
    finally:
        api.stop()
    if answers != streams:
        raise AssertionError("sampled streams through HTTP %r differ from "
                             "the decoder's %r" % (answers, streams))
    print("sampling through HTTP (temperature %g, top-k %d on the API): "
          "%d streams equal the decoder's for the same request ids"
          % (SAMPLE_TEMPERATURE, SAMPLE_TOP_K, len(prompts)))


def post_retrying(port, tokens, n_tokens, codes):
    """POST until a 200, retrying on 429 and 503 (a client of a
    rebuilding replica); every reply's code goes to ``codes``."""
    for attempt in range(600):
        req = urllib.request.Request(
            "http://127.0.0.1:%d/generate" % port,
            data=json.dumps({"tokens": tokens,
                             "n_tokens": n_tokens}).encode(),
            headers={"Content-Type": "application/json"})
        try:
            with urllib.request.urlopen(req, timeout=600) as resp:
                codes.append(resp.status)
                return json.loads(resp.read().decode())["tokens"]
        except urllib.error.HTTPError as err:
            codes.append(err.code)
            if err.code not in (429, 503):
                raise
        time.sleep(0.01 * min(attempt + 1, 20))
    raise AssertionError("no 200 after 600 attempts")


def burst_retrying(port, prompts, codes, n_tokens=N_TOKENS):
    """``burst`` with retries on 429 and 503."""
    streams = [None] * len(prompts)
    errors = []

    def client(i):
        try:
            streams[i] = post_retrying(port, prompts[i], n_tokens, codes)
        except Exception as exc:  # reported below, fails the phase
            errors.append("request %d: %r" % (i, exc))

    threads = [threading.Thread(target=client, args=(i,))
               for i in range(len(prompts))]
    for thread in threads:
        thread.start()
    for thread in threads:
        thread.join(timeout=900)
    if errors or any(thread.is_alive() for thread in threads):
        raise AssertionError("serving failed: %s" % errors)
    return streams


def readyz(port):
    try:
        with urllib.request.urlopen("http://127.0.0.1:%d/readyz" % port,
                                    timeout=60) as resp:
            return resp.status
    except urllib.error.HTTPError as err:
        return err.code


def heal_line(label, api):
    """The last rebuild's trip-to-ready seconds by part, as ms."""
    rb = api.last_rebuild
    return ("%s: trip to ready %.1f ms (shadow capture %.1f, decoder build "
            "%.1f, restore %.1f, probe %.1f); restored %d pages, %d bytes"
            % (label, 1e3 * rb["trip_to_ready_s"], 1e3 * rb["capture_s"],
               1e3 * rb["build_s"], 1e3 * rb["restore_s"],
               1e3 * rb["probe_s"], rb["restored_pages"],
               rb["restored_bytes"]))


def breaker_phase(device):
    """The circuit breaker at the serving model's width in three tiers
    (BREAKER_TIERS): the shared-prompt mix served once (the prefix cache
    fills), then a ServingChaosMonkey failing one step and the same mix
    again, clients retrying on 503 and 429. Every request must end with
    200, /readyz answer 200 with the breaker closed, the paged tiers
    admit the cached system prompt as a hit on the rebuilt decoder (no
    new prefix miss beyond the probe's and the int8-KV tier's cold
    tails), and the
    tier's attend kernel launch at least blocks x steps of the rebuilt
    decoder. Then the paged float tier in f32, requests one at a time:
    the streams after the trip equal a fault-free run's."""
    params, table = bf16_model(device)
    waves = prefix_waves(numpy.random.RandomState(5))
    launches = dict.fromkeys(COUNTERS, 0)
    for label, quantize, paged, attend in BREAKER_TIERS:
        api = GenerateAPI(params, table, HEADS, slots=SLOTS,
                          max_len=MAX_LEN, n_tokens=N_TOKENS, chunk=CHUNK,
                          paged=paged, page_size=PAGE, quantize=quantize,
                          rebuild_backoff=SMOKE_BACKOFF,
                          device=device).start()
        try:
            codes = []
            post(api.port, waves[0][0][:min(16, PAGE - 1)], CHUNK)
            for wave in waves:
                burst_retrying(api.port, wave, codes)
            health0 = api.health.snapshot()
            api.chaos = ServingChaosMonkey(ServingChaosConfig(
                step_fail=1.0, step_fail_max=1))
            for fn in COUNTERS.values():
                fn.launches = 0
            t0 = time.perf_counter()
            streams = [s for wave in waves
                       for s in burst_retrying(api.port, wave, codes)]
            wall = time.perf_counter() - t0
            got = counts()
            health = api.health.snapshot()
            ready = readyz(api.port)
        finally:
            api.stop()
        delta = {k: health["counters"][k] - health0["counters"][k]
                 for k in ("shed", "trips", "rebuilds")}
        chunks = api.decoder.dispatch_counts["chunk"]
        steps = chunks * CHUNK
        print("breaker %s bf16: %d requests x %d tokens over the trip in "
              "%.3f s = %.1f tokens/s; shed %d, trips %d, rebuilds %d; "
              "replies %s; %s launches %d (>= %d blocks x %d steps of the "
              "rebuilt decoder), K2 %d"
              % (label, len(streams), N_TOKENS, wall,
                 len(streams) * N_TOKENS / wall, delta["shed"],
                 delta["trips"], delta["rebuilds"],
                 {c: codes.count(c) for c in sorted(set(codes))}, attend,
                 got[attend], BLOCKS, steps, got["int8_matmul"]))
        print(heal_line("breaker %s" % label, api))
        if delta["trips"] != 1 or delta["rebuilds"] != 1 \
                or delta["shed"] < 1:
            raise AssertionError("the %s breaker did not trip, shed and "
                                 "rebuild once: %s" % (label, delta))
        if ready != 200 or health["breaker"] != "closed" \
                or not health["ready"]:
            raise AssertionError("the %s front did not heal: /readyz %d, "
                                 "%s" % (label, ready, health["breaker"]))
        if set(codes) - {200, 429, 503}:
            raise AssertionError("the %s run answered %s"
                                 % (label, sorted(set(codes))))
        if got[attend] < BLOCKS * steps or steps == 0:
            raise AssertionError("%s launches %d < %d blocks x %d steps"
                                 % (attend, got[attend], BLOCKS, steps))
        if paged:
            hits = health["dispatch_counts"]["admit_hit"]
            misses = (health["pool"]["prefix_misses"]
                      - health0["pool"]["prefix_misses"])
            # the probe's one-token prompt is the one cold admission the
            # float pool makes; the int8-KV pool reuses exact prompts
            # only, so its tails (not page-aligned) go cold too
            cold = 1 + (len(waves[1]) if quantize == "int8-kv" else 0)
            print("breaker %s: on the rebuilt decoder admit_hit %d, "
                  "admit_tail %d, prefix misses +%d (expected +%d)"
                  % (label, hits, health["dispatch_counts"]["admit_tail"],
                     misses, cold))
            if hits < 1 or misses != cold:
                raise AssertionError("the %s pool did not admit the "
                                     "cached prompts as hits over the "
                                     "restored pages" % label)
        for name, n in got.items():
            launches[name] += n
    breaker_agreement(device, waves)
    return launches


def breaker_agreement(device, waves):
    """The paged float tier in f32 at the serving width, the mix posted
    one request at a time twice: with a trip at the start of the second
    pass the second pass's streams equal a fault-free run's, step for
    step (the restored pages are copies; the hits' cached logits
    survive)."""
    rng = numpy.random.RandomState(0)
    params = init_transformer_params(rng, BLOCKS, EMBED, HEADS, VOCAB,
                                     device=device)
    table = torch.from_numpy(
        rng.randn(VOCAB, EMBED).astype(numpy.float32) * 0.02).to(device)
    prompts = [p for wave in waves for p in wave]
    runs = []
    for chaos in (False, True):
        api = GenerateAPI(params, table, HEADS, slots=SLOTS,
                          max_len=MAX_LEN, n_tokens=N_TOKENS, chunk=CHUNK,
                          paged=True, page_size=PAGE,
                          rebuild_backoff=SMOKE_BACKOFF,
                          device=device).start()
        try:
            codes = []
            for prompt in prompts:
                post_retrying(api.port, prompt, N_TOKENS, codes)
            if chaos:
                api.chaos = ServingChaosMonkey(ServingChaosConfig(
                    step_fail=1.0, step_fail_max=1))
            runs.append([post_retrying(api.port, p, N_TOKENS, codes)
                         for p in prompts])
            trips = api.health.counter("trips")
        finally:
            api.stop()
        if trips != int(chaos):
            raise AssertionError("f32 breaker run: %d trips" % trips)
    if runs[0] != runs[1]:
        raise AssertionError("the f32 streams after the trip differ from "
                             "the fault-free run's")
    print("breaker agreement paged float f32: %d streams after the trip "
          "equal the fault-free run's step for step (%d tokens)"
          % (len(prompts), sum(len(s) for s in runs[1])))


def swap_phase(device, prompts):
    """The live hot swap in the int8 tier on the paged pool (K2 + K1) at
    the serving width, f32 activations: weights A serve; a burst holds
    every slot when swap_params(B) is asked for: no reply but 200, and
    the burst's streams equal A's (they drain on A); then each prompt
    equals a fresh GenerateAPI on B, rollback_swap() brings A's streams
    back, and a checkpoint with one NaN leaf is refused, naming it,
    while A keeps serving. Requests are posted one at a time where
    streams are compared across runs, so the batches match."""
    rng = numpy.random.RandomState(0)
    params_a = init_transformer_params(rng, BLOCKS, EMBED, HEADS, VOCAB,
                                       device=device)
    table = torch.from_numpy(
        rng.randn(VOCAB, EMBED).astype(numpy.float32) * 0.02).to(device)
    params_b = init_transformer_params(numpy.random.RandomState(SWAP_SEED),
                                       BLOCKS, EMBED, HEADS, VOCAB,
                                       device=device)

    def api_on(params):
        return GenerateAPI(params, table, HEADS, slots=SLOTS,
                           max_len=MAX_LEN, n_tokens=N_TOKENS, chunk=CHUNK,
                           paged=True, page_size=PAGE, quantize="int8",
                           device=device).start()

    def one_by_one(api):
        return [post(api.port, p, N_TOKENS) for p in prompts]

    fresh = api_on(params_b)
    try:
        want_b = one_by_one(fresh)
    finally:
        fresh.stop()
    api = api_on(params_a)
    try:
        want_a = one_by_one(api)
        answers = [None] * len(prompts)
        codes = []

        def client(i):
            answers[i] = post_retrying(api.port, prompts[i], N_TOKENS,
                                       codes)

        threads = [threading.Thread(target=client, args=(i,))
                   for i in range(len(prompts))]
        first = api.decoder._next_id
        for thread in threads:
            thread.start()
        # every request submitted to the decoder: it decodes on A
        while api.decoder._next_id < first + len(prompts):
            time.sleep(0.001)
        for fn in COUNTERS.values():
            fn.launches = 0
        t0 = time.perf_counter()
        api.swap_params(params_b, version="B")
        swap_wall = time.perf_counter() - t0
        timings = dict(api.last_swap)
        for thread in threads:
            thread.join(timeout=600)
        after = one_by_one(api)
        got = counts()
        api.rollback_swap()
        rolled = one_by_one(api)
        poisoned = dict(params_b, lnf_w=torch.full_like(params_b["lnf_w"],
                                                        float("nan")))
        try:
            api.swap_params(poisoned, version="poisoned")
            refused = None
        except RuntimeError as exc:
            refused = str(exc)
        still = one_by_one(api)
        health = api.health.snapshot()
    finally:
        api.stop()
    print("hot swap int8 f32: swap_params wall %.1f ms (drain %.1f, swap "
          "and quantize %.1f, probe %.1f); replies %s; launches after the "
          "swap K1 %d, K2 %d"
          % (1e3 * swap_wall, 1e3 * timings["drain_s"],
             1e3 * timings["swap_s"], 1e3 * timings["probe_s"],
             {c: codes.count(c) for c in sorted(set(codes))},
             got["paged_attend"], got["int8_matmul"]))
    if set(codes) != {200}:
        raise AssertionError("5xx or 429 across the swap: %s" % codes)
    if answers != want_a:
        raise AssertionError("the in-flight burst did not finish on A")
    if after != want_b:
        raise AssertionError("after the swap the streams differ from a "
                             "fresh API on B")
    if rolled != want_a or still != want_a:
        raise AssertionError("rollback or the refused swap did not leave "
                             "A serving")
    if refused is None or "['lnf_w']" not in refused:
        raise AssertionError("the NaN checkpoint was not refused by "
                             "name: %r" % refused)
    if not got["paged_attend"] or not got["int8_matmul"]:
        raise AssertionError("the swapped weights did not run K1 and K2")
    if health["counters"]["param_swaps"] != 2 \
            or health["counters"]["swap_failures"] != 1:
        raise AssertionError("swap counters %s" % health["counters"])
    print("hot swap: in-flight burst on A, %d prompts equal a fresh API on "
          "B, rollback back to A, NaN checkpoint refused (%s)"
          % (len(prompts), refused))
    return got


def bench_dataset(n=60000, features=784, classes=10, n_valid=10000):
    """The bench's MNIST-shaped set (bench.py:61-81): uniform pixels from
    RandomState(0), class-balanced shuffled labels, valid block first."""
    rng = numpy.random.RandomState(0)
    data = rng.rand(n, features).astype(numpy.float32)
    blocks = []
    for length in (n_valid, n - n_valid):
        block = numpy.tile(numpy.arange(classes, dtype=numpy.int32),
                           length // classes + 1)[:length]
        rng.shuffle(block)
        blocks.append(block)
    return data, numpy.concatenate(blocks)


def build_mlp(device, data, labels, layers, minibatch, class_lengths,
              knobs, epochs, precision_level=0, sweep=True, weights=None,
              fused="auto"):
    """An MLPWorkflow as bench.py builds it (seeds 1234, linear
    normalization, lr 0.03) with the engine knobs set, in the fused tick
    or (``fused=False``) graph mode; ``weights`` (per-layer numpy dicts)
    are put into the units before initialize()."""
    root.common.engine.update({"use_pallas": knobs,
                               "pallas_epilogue": knobs,
                               "precision_level": precision_level})
    prng.get("default").seed(1234)
    prng.get("loader").seed(1234)
    wf = MLPWorkflow(
        DummyLauncher(), layers=layers,
        loader_kwargs=dict(data=data, labels=labels,
                           class_lengths=class_lengths,
                           minibatch_size=minibatch,
                           normalization_type="linear"),
        learning_rate=TRAIN_LR, max_epochs=epochs, fused_sweep=sweep,
        fused=fused, device=device, name="mlp")
    if weights is not None:
        unit_params_from_jax(wf, weights)
    return wf


def train(wf, device):
    """initialize() and run() ``wf``; returns the per-epoch records
    (host clock at the epoch's summary and at run()'s start, train loss,
    validation n_err) and the wall seconds of run(), the card
    synchronised at both ends."""
    epochs = []
    summary = wf.decision._epoch_summary

    def stamped(stats, epoch):
        epochs.append({"t": time.perf_counter(), "t0": t0,
                       "train_loss": stats[TRAIN][2] / max(stats[TRAIN][1],
                                                           1),
                       "valid_n_err": stats[VALID][0],
                       "valid_mse": stats[VALID][2] / max(stats[VALID][1],
                                                          1)})
        summary(stats, epoch)

    wf.decision._epoch_summary = stamped
    wf.initialize()
    if device.type == "cuda":
        torch.cuda.synchronize()
    t0 = time.perf_counter()
    wf.run()
    if device.type == "cuda":
        torch.cuda.synchronize()
    return epochs, time.perf_counter() - t0


def report_training(label, wf, epochs, wall, n_images):
    """Print images/s as bench.py:101-128 reads it (the dataset's images
    over the mean interval between epoch summaries) beside the whole
    run's, and the per-epoch train loss and validation n_err; fail on a
    non-finite loss."""
    stamps = [e["t"] for e in epochs]
    deltas = [b - a for a, b in zip(stamps, stamps[1:])]
    rate = n_images / (sum(deltas) / len(deltas)) if deltas else None
    losses = [e["train_loss"] for e in epochs]
    print("train %s: %d epochs, images/s %s (bench reading: mean of %d "
          "epoch intervals), %.1f over the whole run (%.3f s); train loss "
          "%s; validation n_err %s; minibatches per class (test, valid, "
          "train) %s" % (label, len(epochs),
                         "%.1f" % rate if rate else "n/a", len(deltas),
                         n_images * len(epochs) / wall, wall,
                         ["%.6f" % v for v in losses],
                         [e["valid_n_err"] for e in epochs],
                         minibatch_counts(wf)))
    if not all(math.isfinite(v) for v in losses):
        raise AssertionError("%s: a train loss is not finite" % label)
    return losses


def training_phase(device):
    """The wide MLP on the bench data, 3 epochs, knobs on — the main
    path: the counters are zeroed before the run and must show K6 once
    per train and eval minibatch and K5 once per train minibatch (the
    first layer needs no input gradient; the 10-wide head is no kernel's)
    and no serving kernel; then the same with the knobs off (no kernel)
    twice and on once more (on, off, off, on: both orders, one card), and
    the reference MNIST784 configuration (no kernel). Returns the main
    run's launches."""
    data, labels = bench_dataset()
    runs = [("wide MLP 784-4096-10 mb 4096, knobs %s"
             % ("on" if knobs else "off"), WIDE_LAYERS, WIDE_MINIBATCH, knobs)
            for knobs in (True, False, False, True)]
    runs.append(("reference MNIST784 784-100-10 mb 100", MNIST_LAYERS,
                 MNIST_MINIBATCH, False))
    main = None
    for label, layers, minibatch, knobs in runs:
        wf = build_mlp(device, data, labels, layers, minibatch,
                       BENCH_CLASS_LENGTHS, knobs, TRAIN_EPOCHS)
        for fn in COUNTERS.values():
            fn.launches = 0
        epochs, wall = train(wf, device)
        got = counts()
        losses = report_training(label, wf, epochs, wall, len(data))
        test, valid, train_mb = wf.fused_tick.minibatch_counts
        want = dict.fromkeys(COUNTERS, 0)
        if knobs:
            want.update(dense_epilogue=test + valid + train_mb,
                        blocked_matmul=train_mb)
            main = main or got
            if not losses[-1] < losses[0]:
                raise AssertionError("the last epoch's train loss %.6f is "
                                     "not below the first's %.6f"
                                     % (losses[-1], losses[0]))
        print("  launches %s (the tick's minibatches require %s)"
              % (got, {k: v for k, v in want.items() if v}))
        if got != want or len(epochs) != TRAIN_EPOCHS:
            raise AssertionError("%s: %d epochs, launches %s, expected %s"
                                 % (label, len(epochs), got, want))
        del wf
    return main


def minibatch_counts(wf):
    """The (test, valid, train) minibatches the run stepped: the fused
    tick's count, or in graph mode and the lower tiers the loader's
    epochs times its minibatches a class."""
    if wf.fused_tick is not None:
        return wf.fused_tick.minibatch_counts
    size = wf.loader.max_minibatch_size
    return [wf.decision.epochs_done * -(-n // size)
            for n in wf.loader.class_lengths]


def recorded_run(wf):
    """initialize() and run() a per-minibatch workflow (the fused tick, or
    graph mode: the evaluator's firing) with the counters zeroed first;
    returns the served index blocks, each tick's n_err, the launches and
    the wall seconds of run() (the card synchronised)."""
    served, n_errs = [], []
    serve_next = wf.loader.serve_next_minibatch

    def recorded():
        block = serve_next()
        served.append(block[1])
        return block

    wf.loader.serve_next_minibatch = recorded
    wf.initialize()
    tick = wf.fused_tick or wf.evaluator
    tick_run = tick.run

    def counted():
        tick_run()
        n_errs.append(int(wf.evaluator.n_err.data))

    tick.run = counted
    for fn in COUNTERS.values():
        fn.launches = 0
    t0 = time.perf_counter()
    wf.run()
    if wf.device.type == "cuda":
        torch.cuda.synchronize()
    return served, n_errs, counts(), time.perf_counter() - t0


def training_agreement_phase(device):
    """One epoch of the wide MLP at precision level 2 (K5 and K6 on f32
    operands) on the card and on the CPU (plain versions), per-minibatch
    serving, from the same weights drawn with numpy: the served index
    streams must be equal, each minibatch's n_err within
    AGREE_N_ERR_TOL, the final weights within AGREE_WEIGHT_ATOL."""
    data, labels = bench_dataset()
    n = sum(AGREE_CLASS_LENGTHS)
    data, labels = data[:n], labels[:n]
    rng = numpy.random.RandomState(5)
    weights, fan_in = [], data.shape[1]
    for width in WIDE_LAYERS:
        bound = 1.0 / math.sqrt(fan_in)
        weights.append({
            "weights": rng.uniform(-bound, bound, (fan_in, width)),
            "bias": rng.uniform(-bound, bound, width)})
        fan_in = width
    results = []
    for dev in (device, torch.device("cpu")):
        wf = build_mlp(dev, data, labels, WIDE_LAYERS, WIDE_MINIBATCH,
                       AGREE_CLASS_LENGTHS, True, 1, precision_level=2,
                       sweep=False, weights=weights)
        served, n_errs, got, _ = recorded_run(wf)
        results.append((served, n_errs, [
            f.weights.data.cpu() for f in wf.forwards], got))
    (served_c, errs_c, w_c, got_c), (served_h, errs_h, w_h, got_h) = results
    same_stream = len(served_c) == len(served_h) and all(
        numpy.array_equal(a, b) for a, b in zip(served_c, served_h))
    n_err_diff = max(abs(a - b) for a, b in zip(errs_c, errs_h))
    w_diff = max((a - b).abs().max().item() for a, b in zip(w_c, w_h))
    print("training agreement f32 (level 2), 1 epoch, %d minibatches: "
          "index streams %s; n_err card %s, CPU %s (max diff %d, tolerance "
          "%d); weights max abs diff %.3g (tolerance %.0e); card launches "
          "K5 %d, K6 %d; CPU launches %d"
          % (len(served_c), "equal" if same_stream else "DIFFER", errs_c,
             errs_h, n_err_diff, AGREE_N_ERR_TOL, w_diff,
             AGREE_WEIGHT_ATOL, got_c["blocked_matmul"],
             got_c["dense_epilogue"], sum(got_h.values())))
    if not same_stream or len(errs_c) != len(errs_h) \
            or n_err_diff > AGREE_N_ERR_TOL or not w_diff <= AGREE_WEIGHT_ATOL:
        raise AssertionError("the card's training disagrees with the CPU's")
    if not (got_c["blocked_matmul"] and got_c["dense_epilogue"]) \
            or any(got_h.values()):
        raise AssertionError("the card run skipped a kernel or the CPU run "
                             "launched one")


def balanced_labels(rng, classes, *lengths):
    """Label blocks, each as class-balanced as its length allows and
    shuffled (bench.py:61-73)."""
    blocks = []
    for length in lengths:
        block = numpy.tile(numpy.arange(classes, dtype=numpy.int32),
                           length // classes + 1)[:length]
        rng.shuffle(block)
        blocks.append(block)
    return numpy.concatenate(blocks)


def alexnet_dataset():
    """bench.py:786-792's AlexNet data: RandomState(0) pixels in [0, 255)
    of 227 x 227 x 3 (1.85 GB as f32), 1000 valid then 2000 train,
    exactly proportional over the 1000 classes."""
    rng = numpy.random.RandomState(0)
    n = sum(ALEX_CLASS_LENGTHS)
    data = (rng.rand(n, ALEX_HW, ALEX_HW, 3) * 255).astype(numpy.float32)
    return data, balanced_labels(rng, ALEX_CLASSES, *ALEX_CLASS_LENGTHS[1:])


def build_standard(device, data, labels, class_lengths, minibatch, epochs,
                   knobs=False, precision_level=0, sweep=True, layers=None,
                   scale=1.0, n_classes=ALEX_CLASSES, transform=None,
                   normalization="mean_disp", **trainer):
    """AlexNetWorkflow (or, with ``layers``, a StandardWorkflow of them)
    as bench.py:793-803 builds it (seeds 1, the JAX package's trainer
    defaults) with the engine knobs and precision level set; unpipelined
    (each epoch's summary waits for that epoch on the card, so the
    intervals between summaries are the epochs' times)."""
    root.common.engine.update({"use_pallas": knobs,
                               "pallas_epilogue": knobs,
                               "precision_level": precision_level})
    prng.get("default").seed(1)
    prng.get("loader").seed(1)
    kwargs = dict(loader_kwargs=dict(data=data, labels=labels,
                                     class_lengths=class_lengths,
                                     minibatch_size=minibatch,
                                     normalization_type=normalization,
                                     train_transform=transform),
                  decision_kwargs=dict(max_epochs=epochs),
                  fused_sweep=sweep, fused_pipeline=False, device=device,
                  **trainer)
    if layers is None:
        return AlexNetWorkflow(DummyLauncher(), n_classes=n_classes,
                               scale=scale, name="alexnet", **kwargs)
    return StandardWorkflow(DummyLauncher(), layers=layers, name="convnet",
                            **kwargs)


def report_epochs(label, wf, epochs, wall, n_images):
    """Images/s over the whole run and in each epoch (the interval since
    the previous epoch's summary; the first from the run's start), the
    per-epoch train loss and validation n_err; fails on a non-finite
    loss."""
    losses = [e["train_loss"] for e in epochs]
    stamps = [epochs[0]["t0"]] + [e["t"] for e in epochs]
    per_epoch = [n_images / (b - a) for a, b in zip(stamps, stamps[1:])]
    print("train %s: %d epochs in %.3f s, %.1f images/s over the run; per "
          "epoch %s; train loss %s; validation n_err %s; minibatches per "
          "class (test, valid, train) %s"
          % (label, len(epochs), wall, n_images * len(epochs) / wall,
             ["%.1f" % r for r in per_epoch], ["%.6f" % v for v in losses],
             [e["valid_n_err"] for e in epochs],
             wf.fused_tick.minibatch_counts))
    if not all(math.isfinite(v) for v in losses):
        raise AssertionError("%s: a train loss is not finite" % label)
    return n_images * len(epochs) / wall


def alexnet_phase(device):
    """AlexNet-227 (bench.py:777-817) on the card: minibatch 128, level 0,
    the knobs at their defaults, ALEX_EPOCHS epochs; then minibatch 512
    with use_pallas and pallas_epilogue on (the main path of K6 forward
    and K5 backward at the three dense layers: 9216 -> 4096 -> 4096 ->
    1000; the counters are zeroed before the run) and off. Images/s and
    per-epoch losses for each; returns the knobs-on run's launches."""
    t0 = time.perf_counter()
    data, labels = alexnet_dataset()
    n = len(data)
    print("AlexNet data: %d x %d x %d x 3 f32 (%.2f GB) in %.1f s"
          % (n, ALEX_HW, ALEX_HW, data.nbytes / 1e9,
             time.perf_counter() - t0))
    main = None
    for minibatch, epochs, knobs in (
            (ALEX_MINIBATCH, ALEX_EPOCHS, False),
            (ALEX_KNOBS_MINIBATCH, ALEX_KNOBS_EPOCHS, True),
            (ALEX_KNOBS_MINIBATCH, ALEX_KNOBS_EPOCHS, False)):
        wf = build_standard(device, data, labels, ALEX_CLASS_LENGTHS,
                            minibatch, epochs, knobs=knobs)
        for fn in COUNTERS.values():
            fn.launches = 0
        records, wall = train(wf, device)
        got = counts()
        label = "AlexNet-227 mb %d, knobs %s" % (minibatch,
                                                  "on" if knobs else "off")
        report_epochs(label, wf, records, wall, n)
        _, valid, train_mb = wf.fused_tick.minibatch_counts
        print("  launches K5 %d, K6 %d (%d valid and %d train minibatches)"
              % (got["blocked_matmul"], got["dense_epilogue"], valid,
                 train_mb))
        if len(records) != epochs:
            raise AssertionError("%s ran %d epochs" % (label, len(records)))
        others = sum(v for k, v in got.items()
                     if k not in ("blocked_matmul", "dense_epilogue"))
        if knobs:
            # three dense forwards a minibatch; the backward's weight and
            # input gradients (the first dense layer's input gradient
            # goes to the last pool, so it is taken too)
            if got["dense_epilogue"] < 3 * (valid + train_mb) \
                    or got["blocked_matmul"] < 3 * train_mb or others:
                raise AssertionError("%s: launches %s" % (label, got))
            main = got
        elif any(got.values()):
            raise AssertionError("%s launched a kernel: %s" % (label, got))
        del wf
        torch.cuda.empty_cache()
    print("AlexNet phase: %.1f s" % (time.perf_counter() - t0))
    return main


def unit_leaves(wf):
    """Each forward's weights and bias as numpy ({} for a pool): what
    ``unit_params_from_jax`` takes."""
    return [{"weights": f.weights.data.cpu().numpy().copy(),
             "bias": f.bias.data.cpu().numpy().copy()}
            if getattr(f, "weights", None) is not None else {}
            for f in wf.forwards]


def conv_recorded_run(wf):
    """initialize() and run() a per-minibatch convnet; returns each tick's
    served indices with its augmentation seed, each tick's n_err, the
    initial and the final leaves, and the launches."""
    served, n_errs = [], []
    loader_run = wf.loader.run

    def recorded():
        loader_run()
        served.append((wf.loader.minibatch_indices.data.copy(),
                       getattr(wf.loader, "minibatch_transform_seed", 0)))

    wf.loader.run = recorded
    wf.initialize()
    initial = unit_leaves(wf)
    tick_run = wf.fused_tick.run

    def counted():
        tick_run()
        n_errs.append(int(wf.evaluator.n_err.data))

    wf.fused_tick.run = counted
    for fn in COUNTERS.values():
        fn.launches = 0
    wf.run()
    if wf.device.type == "cuda":
        torch.cuda.synchronize()
    return served, n_errs, initial, unit_leaves(wf), counts()


def conv_agreement_phase(device):
    """One epoch at precision level 2 on the CPU and on the card from the
    same weights (the CPU run's initial ones carried across),
    per-minibatch serving: (a) AlexNet at scale 1/8 on 67 x 67 x 3
    pixels, (b) the digits_conv stack with maxabs pooling and shift1 on
    8 x 8 x 1 pixels. The served indices and augmentation seeds must be
    equal, each minibatch's n_err within CONV_N_ERR_TOL, every leaf
    within CONV_LEAF_RTOL of its largest element."""
    t0 = time.perf_counter()
    rng = numpy.random.RandomState(8)
    n = sum(CONV_AGREE_CLASS_LENGTHS)
    alex = dict(data=(rng.rand(n, CONV_AGREE_HW, CONV_AGREE_HW, 3)
                      * 255).astype(numpy.float32),
                labels=balanced_labels(rng, 10,
                                       *CONV_AGREE_CLASS_LENGTHS[1:]),
                class_lengths=CONV_AGREE_CLASS_LENGTHS, minibatch=64,
                scale=CONV_AGREE_SCALE, n_classes=10)
    n = sum(DIGITS_CLASS_LENGTHS)
    digits = dict(data=(rng.rand(n, 8, 8, 1) * 16).astype(numpy.float32),
                  labels=balanced_labels(rng, 10, *DIGITS_CLASS_LENGTHS[1:]),
                  class_lengths=DIGITS_CLASS_LENGTHS, minibatch=100,
                  layers=DIGITS_CONV_LAYERS, transform="shift1",
                  normalization="linear", learning_rate=0.02,
                  gradient_moment=0.9)
    for label, config in (("AlexNet scale 1/8, 67 x 67", alex),
                          ("digits_conv maxabs + shift1, 8 x 8", digits)):
        config = dict(config)
        args = [config.pop(key) for key in ("data", "labels",
                                            "class_lengths", "minibatch")]
        host = build_standard(torch.device("cpu"), *args, 1,
                              precision_level=2, sweep=False, **config)
        served_h, errs_h, initial, leaves_h, got_h = conv_recorded_run(host)
        card = build_standard(device, *args, 1, precision_level=2,
                              sweep=False, **config)
        unit_params_from_jax(card, initial)
        served_c, errs_c, _, leaves_c, got_c = conv_recorded_run(card)
        same = len(served_c) == len(served_h) and all(
            numpy.array_equal(a[0], b[0]) and a[1] == b[1]
            for a, b in zip(served_c, served_h))
        seeds = sum(1 for _, seed in served_c if seed)
        n_err_diff = max(abs(a - b) for a, b in zip(errs_c, errs_h))
        leaf_rel = max(float(numpy.abs(a[k] - b[k]).max()
                             / numpy.abs(b[k]).max())
                       for a, b in zip(leaves_c, leaves_h) for k in b)
        print("conv agreement %s, f32 (level 2), 1 epoch, %d minibatches: "
              "index streams and %d augmentation seeds %s; n_err card %s, "
              "CPU %s (max diff %d, tolerance %d); leaves max diff %.3g of "
              "their largest (tolerance %.0e); launches card %d, CPU %d"
              % (label, len(served_c), seeds,
                 "equal" if same else "DIFFER", errs_c, errs_h, n_err_diff,
                 CONV_N_ERR_TOL, leaf_rel, CONV_LEAF_RTOL,
                 sum(got_c.values()), sum(got_h.values())))
        if not same or len(errs_c) != len(errs_h) \
                or n_err_diff > CONV_N_ERR_TOL \
                or not leaf_rel <= CONV_LEAF_RTOL:
            raise AssertionError("the card's %s training disagrees with the "
                                 "CPU's" % label)
    print("conv agreement phase: %.1f s" % (time.perf_counter() - t0))


def flash_problem(gen, device, shape, dtype):
    """q, k, v of the (batch, T, heads, head_dim) ``shape`` as the qkv
    projection hands them to the kernels: split views of one (batch, T,
    3 heads head_dim) tensor, read in place; and a random dO."""
    batch, t, heads, dim = shape
    qkv = torch.randn((batch, t, 3 * heads * dim), generator=gen,
                      device=device).to(dtype)
    q, k, v = (part.reshape(shape) for part in qkv.split(heads * dim, -1))
    do = torch.randn(shape, generator=gen, device=device).to(dtype)
    return q, k, v, do


def row_errors(out, ref):
    """The worst row's error relative to that row's own norm (a row: the
    last axis, one position's head_dim values for one head; the norm at
    least FLASH_ROW_FLOOR of the median row's), that row's position on
    axis 1, and the whole tensor's error relative to the reference's
    norm."""
    diff, ref = out.float() - ref.float(), ref.float()
    norms = ref.norm(dim=-1)
    rows = diff.norm(dim=-1) / norms.clamp_min(
        FLASH_ROW_FLOOR * norms.median())
    worst = rows.flatten().argmax().item()
    return (rows.flatten()[worst].item(),
            worst // rows.shape[2] % rows.shape[1],
            (diff.norm() / ref.norm()).item())


def flash_error(label, out, ref, tol):
    """Hold ``out`` (B, T, H, D) against ``ref`` row by row: the worst
    row's error relative to its own norm within ``tol`` (and so the max
    abs error within ``tol`` of the largest |reference|). A planted
    fault, the last FLASH_TILE positions' rows of ``out`` scaled by
    FLASH_FAULT, must read past ``tol``. Prints the readings; returns the
    max abs error."""
    worst, where, whole = row_errors(out, ref)
    planted = out.float().clone()
    planted[:, -FLASH_TILE:] *= FLASH_FAULT
    control = row_errors(planted, ref)[0]
    err = (out.float() - ref.float()).abs().max().item()
    print("%s: worst row %.3g of its own norm at position %d (tolerance "
          "%.0e), whole tensor %.3g of its norm, max_abs_err %.3g; planted "
          "fault (last %d positions x %g) reads %.3g"
          % (label, worst, where, tol, whole, err, FLASH_TILE, FLASH_FAULT,
             control))
    if not (worst <= tol and err <= tol * ref.float().abs().max().item()):
        raise AssertionError("%s disagrees with its plain version" % label)
    if not control > tol:
        raise AssertionError("%s: the check does not see the planted fault"
                             % label)
    return err


def flash_ops(shape, products):
    """The operations of a causal flash call at ``shape``: ``products``
    products of 2 D operations over the T (T + 1) / 2 visible pairs of
    each (row, head)."""
    batch, t, heads, dim = shape
    return products * 2 * dim * batch * heads * t * (t + 1) // 2


def flash_bound(shape, products, nbytes):
    """The least time of a causal flash call at ``shape``: its
    operations at the bf16 tensor-core rate, or ``nbytes`` at the memory
    rate, whichever is larger."""
    bytes_s = nbytes / HBM_BYTES_PER_S
    ops_s = flash_ops(shape, products) / BF16_OPS_PER_S
    return 1e3 * max(bytes_s, ops_s), ("bytes" if bytes_s >= ops_s
                                       else "operations")


def schedule_tail(walks, sms):
    """A model of a causal kernel's last wave, not a measurement: blocks
    whose work is ``walks`` (tiles walked), dispatched longest first, each
    to the SM that frees first (one block an SM). Returns when the last SM
    ends, as a share of the time a perfect balance would take."""
    loads = [0] * sms
    for walk in sorted(walks, reverse=True):
        heapq.heapreplace(loads, loads[0] + walk)
    return max(loads) * sms / sum(walks)


def flash_schedules(shape):
    """The 128-wide K8's and K9's walks at a causal ``shape``, in 64-row
    tiles: K8's block of 128 keys from k0 walks the queries from k0 on, K9's
    block of 128 queries the keys up to its last query."""
    batch, t, heads, _ = shape
    blocks = range(0, t, 128)
    per_row = batch * heads
    return {"dkv": [-(-(t - k0) // 64) for k0 in blocks] * per_row,
            "dq": [-(-min(t, q0 + 128) // 64) for q0 in blocks] * per_row}


def check_backward(label, q, k, v, do, out, lse):
    """K8 and K9 against their plain versions on the forward's ``out``
    and ``lse`` (flash_error's row-wise rule, FLASH_BWD_RTOL, with its
    planted fault). Returns (K8's max abs error, K9's, di)."""
    di = _row_dot(out, do)
    dk, dv = flash_attention_dkv(q, k, v, do, lse, di, True)
    ref_dk, ref_dv = _flash_attention_dkv_plain(q, k, v, do, lse, di, True)
    torch.cuda.synchronize()
    dkv = max(flash_error("K8 flash_attention_dkv dK " + label, dk, ref_dk,
                          FLASH_BWD_RTOL),
              flash_error("K8 flash_attention_dkv dV " + label, dv, ref_dv,
                          FLASH_BWD_RTOL))
    del dk, dv, ref_dk, ref_dv
    dq = flash_attention_dq(q, k, v, do, lse, di, True)
    ref_dq = _flash_attention_dq_plain(q, k, v, do, lse, di, True)
    torch.cuda.synchronize()
    return dkv, flash_error("K9 flash_attention_dq dQ " + label, dq, ref_dq,
                            FLASH_BWD_RTOL), di


def flash_phase(timer, device, gen):
    """K7 against its plain version at a ragged serving prefill (2 rows
    of 5000 positions, bf16 and f32) and at the training shape (1, 8192,
    8, 128) bf16, causal; K8 and K9 at both shapes in bf16 (the serving
    shape's batch and ragged T reach the tiles' edges, which 8192 hides).
    Each timed at the training shape beside its plain version and the
    library yardstick: scaled_dot_product_attention(is_causal=True)
    forward for K7, its autograd backward (dQ, dK and dV in one call) for
    K8 and K9; the rates beside the bound, and a model of K8's and K9's
    last wave."""
    worst = {"fwd": 0.0, "dkv": 0.0, "dq": 0.0}
    for dtype in (torch.bfloat16, torch.float32):
        q, k, v, do = flash_problem(gen, device, FLASH_SERVE_SHAPE, dtype)
        label = "%s %s" % ("x".join(map(str, FLASH_SERVE_SHAPE)),
                           str(dtype).split(".")[-1])
        out, lse = flash_attention_fwd(q, k, v, True)
        ref, _ = _flash_attention_fwd_plain(q, k, v, True)
        torch.cuda.synchronize()
        worst["fwd"] = max(worst["fwd"], flash_error(
            "K7 flash_attention_fwd " + label, out, ref,
            K7_RTOL if dtype == torch.bfloat16 else K7_F32_RTOL))
        if dtype == torch.bfloat16:
            worst["dkv"], worst["dq"], _ = check_backward(label, q, k, v, do,
                                                          out, lse)
    q, k, v, do = flash_problem(gen, device, FLASH_TRAIN_SHAPE,
                                torch.bfloat16)
    label = "x".join(map(str, FLASH_TRAIN_SHAPE)) + " bf16"
    out, lse = flash_attention_fwd(q, k, v, True)
    ref, _ = _flash_attention_fwd_plain(q, k, v, True)
    torch.cuda.synchronize()
    worst["fwd"] = max(worst["fwd"], flash_error(
        "K7 flash_attention_fwd " + label, out, ref, K7_RTOL))
    del ref
    dkv_err, dq_err, di = check_backward(label, q, k, v, do, out, lse)
    worst["dkv"] = max(worst["dkv"], dkv_err)
    worst["dq"] = max(worst["dq"], dq_err)
    sdpa = torch.nn.functional.scaled_dot_product_attention
    heads_first = [t.transpose(1, 2) for t in (q, k, v)]
    leaves = [t.detach().requires_grad_(True) for t in heads_first]
    lib_out = sdpa(*leaves, is_causal=True)
    lib_do = do.transpose(1, 2)
    lib_bwd_ms = timer(lambda: torch.autograd.grad(lib_out, leaves, lib_do,
                                                   retain_graph=True))
    times = {
        "fwd": (timer(lambda: flash_attention_fwd(q, k, v, True)),
                timer(lambda: _flash_attention_fwd_plain(q, k, v, True)),
                timer(lambda: sdpa(*heads_first, is_causal=True))),
        "dkv": (timer(lambda: flash_attention_dkv(q, k, v, do, lse, di,
                                                  True)),
                timer(lambda: _flash_attention_dkv_plain(q, k, v, do, lse,
                                                         di, True)),
                lib_bwd_ms),
        "dq": (timer(lambda: flash_attention_dq(q, k, v, do, lse, di,
                                                True)),
               timer(lambda: _flash_attention_dq_plain(q, k, v, do, lse, di,
                                                       True)),
               lib_bwd_ms)}
    operand = q.numel() * q.element_size()
    row_stats = lse.numel() * 4
    # (products, bytes: each input read once, each output written once)
    work = {"fwd": (2, 4 * operand + row_stats),
            "dkv": (4, 6 * operand + 2 * row_stats),
            "dq": (3, 5 * operand + 2 * row_stats)}
    source = {"fwd": ("flash_attention.cu", 331),
              "dkv": ("flash_attention_bwd.cu", 796),
              "dq": ("flash_attention_bwd.cu", 1146)}
    # no library call computes dK, dV or dQ alone: K8's and K9's
    # library_ms is one call that computes all three, so it is held
    # against K8 + K9 together, not against either
    library = {"fwd": "scaled_dot_product_attention(is_causal=True)",
               "dkv": "scaled_dot_product_attention's autograd backward "
                      "(dQ, dK and dV in one call; the same call as K9's)",
               "dq": "scaled_dot_product_attention's autograd backward "
                     "(dQ, dK and dV in one call; the same call as K8's)"}
    entries = []
    for key, number in (("fwd", "K7"), ("dkv", "K8"), ("dq", "K9")):
        ms, plain_ms, library_ms = times[key]
        bound_ms, bound_by = flash_bound(FLASH_TRAIN_SHAPE, *work[key])
        print("%s flash_attention_%s %s causal: ms %.4f (%.1f TFLOP/s) "
              "plain_ms %.4f sdpa_%s_ms %.4f bound_ms %.4f (%s, %.0f TFLOP/s)"
              % (number, key, label, ms,
                 flash_ops(FLASH_TRAIN_SHAPE, work[key][0]) / ms / 1e9,
                 plain_ms, "fwd" if key == "fwd" else "bwd", library_ms,
                 bound_ms, bound_by, BF16_OPS_PER_S / 1e12))
        entries.append({
            "name": "flash_attention_" + key, "route": "cuda",
            "source": "veles_tpu_torch/ops/csrc/" + source[key][0],
            "replaces": "jax/experimental/pallas/ops/tpu/flash_attention.py:"
                        "%d (via veles_tpu/ops/attention.py:34)"
                        % source[key][1],
            "max_abs_err": worst[key], "ms": ms, "plain_ms": plain_ms,
            "bound_ms": bound_ms, "bound_by": bound_by,
            "library_ms": library_ms, "library": library[key]})
    print("K8 + K9 %.4f ms against sdpa_bwd_ms %.4f (one call computing dQ, "
          "dK and dV)" % (times["dkv"][0] + times["dq"][0], lib_bwd_ms))
    sms = torch.cuda.get_device_properties(device).multi_processor_count
    for key, walks in flash_schedules(FLASH_TRAIN_SHAPE).items():
        print("%s schedule model at %s: %d blocks walking %d-%d tiles of 64, "
              "longest first over %d SMs: the last SM ends at %.4f of a "
              "perfect balance" % ("K8" if key == "dkv" else "K9", label,
                                   len(walks), min(walks), max(walks), sms,
                                   schedule_tail(walks, sms)))
    return entries


def flash_wide_phase(timer, device, gen):
    """K7, K8 and K9 at the wider heads the flash rule admits
    (FLASH_WIDE_SHAPES, causal bf16: K7's 256-wide wgmma kernel, the
    chunked kernels at 384 and for K8 and K9 at both) and f32 K7 at 256,
    each against its plain version under the row-wise rule with its
    planted fault, each timed beside its plain version and SDPA; then one
    attention() call at 4096 positions with 256-wide heads, which must run
    K7 (one launch). Returns the largest max abs error of each kernel."""
    worst = {"fwd": 0.0, "dkv": 0.0, "dq": 0.0}
    sdpa = torch.nn.functional.scaled_dot_product_attention
    for shape in FLASH_WIDE_SHAPES:
        label = "x".join(map(str, shape)) + " bf16"
        q, k, v, do = flash_problem(gen, device, shape, torch.bfloat16)
        out, lse = flash_attention_fwd(q, k, v, True)
        ref, _ = _flash_attention_fwd_plain(q, k, v, True)
        torch.cuda.synchronize()
        worst["fwd"] = max(worst["fwd"], flash_error(
            "K7 flash_attention_fwd " + label, out, ref, K7_RTOL))
        del ref
        dkv_err, dq_err, di = check_backward(label, q, k, v, do, out, lse)
        worst["dkv"] = max(worst["dkv"], dkv_err)
        worst["dq"] = max(worst["dq"], dq_err)
        heads_first = [t.transpose(1, 2) for t in (q, k, v)]
        leaves = [t.detach().requires_grad_(True) for t in heads_first]
        lib_out = sdpa(*leaves, is_causal=True)
        lib_do = do.transpose(1, 2)
        times = {
            "K7": (lambda: flash_attention_fwd(q, k, v, True),
                   lambda: _flash_attention_fwd_plain(q, k, v, True),
                   lambda: sdpa(*heads_first, is_causal=True)),
            "K8": (lambda: flash_attention_dkv(q, k, v, do, lse, di, True),
                   lambda: _flash_attention_dkv_plain(q, k, v, do, lse, di,
                                                      True),
                   lambda: torch.autograd.grad(lib_out, leaves, lib_do,
                                               retain_graph=True)),
            "K9": (lambda: flash_attention_dq(q, k, v, do, lse, di, True),
                   lambda: _flash_attention_dq_plain(q, k, v, do, lse, di,
                                                     True), None)}
        for number, (fn, plain, lib) in times.items():
            print("%s %s causal: ms %.4f plain_ms %.4f %s"
                  % (number, label, timer(fn), timer(plain),
                     "sdpa_ms %.4f" % timer(lib) if lib else
                     "(SDPA's backward is K8's yardstick)"))
        del lib_out, leaves
    q, k, v, _ = flash_problem(gen, device, FLASH_WIDE_F32_SHAPE,
                               torch.float32)
    label = "x".join(map(str, FLASH_WIDE_F32_SHAPE)) + " f32"
    out, _ = flash_attention_fwd(q, k, v, True)
    ref, _ = _flash_attention_fwd_plain(q, k, v, True)
    torch.cuda.synchronize()
    worst["fwd"] = max(worst["fwd"], flash_error(
        "K7 flash_attention_fwd " + label, out, ref, K7_F32_RTOL))
    print("K7 %s causal: ms %.4f plain_ms %.4f"
          % (label, timer(lambda: flash_attention_fwd(q, k, v, True)),
             timer(lambda: _flash_attention_fwd_plain(q, k, v, True))))
    # the port's attention() where the flash rule holds at 256-wide heads
    q, k, v, _ = flash_problem(gen, device, FLASH_WIDE_F32_SHAPE,
                               torch.bfloat16)
    before = flash_attention_fwd.launches
    out = attention(q, k, v, causal=True)
    torch.cuda.synchronize()
    if flash_attention_fwd.launches != before + 1:
        raise AssertionError("attention() at %s launched K7 %d times, not "
                             "once" % (FLASH_WIDE_F32_SHAPE,
                                       flash_attention_fwd.launches - before))
    flash_error("attention() %s bf16 (K7)" % "x".join(
        map(str, FLASH_WIDE_F32_SHAPE)), out,
        _flash_attention_fwd_plain(q, k, v, True)[0], K7_RTOL)
    return worst


def long_serving_phase(device, rng):
    """Three long prompts (8192, 6000 and 4096 tokens, 32 tokens each) at
    once through GenerateAPI on the dense slab, bf16 float tier, at the
    serving model's width with 8 heads of 128: every request answered,
    and each prefill (one per prompt bucket group, every bucket >= 4096)
    launching K7 once per block and no other kernel."""
    params, table = bf16_model(device)
    prompts = [rng.randint(0, VOCAB, n).tolist() for n in LONG_PROMPTS]
    run = serve(params, table, [prompts], None, device, paged=False,
                heads=LONG_HEADS, max_len=LONG_MAX_LEN, slots=len(prompts))
    got = run["launches"]
    admits = (run["health"]["dispatch_counts"]["admit"]
              - run["health0"]["dispatch_counts"]["admit"])
    print("long prompts %s bf16 (dense slab, %d heads of %d, max_len %d): "
          "%d requests x %d tokens in %.3f s = %.1f tokens/s; %d prefills "
          "(prompt bucket groups), prefill host-blocking %.3f ms (admit_s), "
          "dispatch + collect %.3f ms over %d chunks; launches K7 %d "
          "(%d blocks x %d prefills)"
          % (list(LONG_PROMPTS), LONG_HEADS, EMBED // LONG_HEADS,
             LONG_MAX_LEN, len(prompts), N_TOKENS, run["wall"],
             len(prompts) * N_TOKENS / run["wall"], admits,
             1e3 * run["admit_s"], 1e3 * run["host_s"], run["chunks"],
             got["flash_attention_fwd"], BLOCKS, admits))
    if admits < 1 or got["flash_attention_fwd"] != BLOCKS * admits:
        raise AssertionError("K7 launched %d times for %d long prefills"
                             % (got["flash_attention_fwd"], admits))
    others = {name: n for name, n in got.items()
              if n and name != "flash_attention_fwd"}
    if others:
        raise AssertionError("the long-prompt run launched %s" % others)
    return got


def long_agreement_phase(device):
    """float32 weights: a 4096-token prompt through GenerateAPI on the
    dense slab on the card (K7 in f32, once per block) against the dense
    reference decode on the CPU (plain attention), greedy tokens equal up
    to the first step where the reference's top-2 gap is below 1e-3."""
    rng = numpy.random.RandomState(0)
    params = init_transformer_params(rng, BLOCKS, EMBED, LONG_HEADS, VOCAB,
                                     device="cpu")
    table = torch.from_numpy(
        rng.randn(VOCAB, EMBED).astype(numpy.float32) * 0.02)
    prompt = numpy.random.RandomState(3).randint(0, VOCAB,
                                                 LONG_AGREE_PROMPT).tolist()
    run = serve(params, table, [[prompt]], None, device, paged=False,
                heads=LONG_HEADS,
                max_len=LONG_AGREE_PROMPT + N_TOKENS + 2 * CHUNK, slots=1)
    if run["launches"]["flash_attention_fwd"] != BLOCKS:
        raise AssertionError("the f32 long prefill launched K7 %d times"
                             % run["launches"]["flash_attention_fwd"])
    ref, _, logits = generate(params, table, numpy.asarray(prompt)[None],
                              LONG_HEADS, N_TOKENS, return_logits=True,
                              device="cpu")
    top2 = torch.topk(logits[0], 2, dim=-1).values
    gaps = (top2[:, 0] - top2[:, 1]).tolist()
    n = next((i for i, g in enumerate(gaps) if g < TOP2_GAP), len(gaps))
    want = ref[0, :n].tolist()
    stream = run["streams"][0]
    print("agreement long prompt f32 (%d tokens, K7 f32 on the card vs the "
          "CPU's plain attention): %d steps compared, %d cut off at a "
          "reference top-2 gap below %.0e; K7 launches %d"
          % (LONG_AGREE_PROMPT, n, len(gaps) - n, TOP2_GAP,
             run["launches"]["flash_attention_fwd"]))
    if stream[:n] != want:
        raise AssertionError("the long-prompt stream disagrees with the "
                             "reference: %r vs %r" % (stream[:n], want))


def split_labels(rng, classes, class_lengths):
    """Labels for a (test, valid, train) split, valid first: the train
    labels randint(0, classes), the valid ones drawn from them (the loader
    wants every validation label in the training set)."""
    _, n_valid, n_train = class_lengths
    train_labels = rng.randint(0, classes, n_train)
    return numpy.concatenate(
        [train_labels[rng.randint(0, n_train, n_valid)], train_labels])


def transformer_layers(heads, classes, depth):
    """transformer_device's pre-LN stack (bench.py:425-441): ``depth`` x
    [layer_norm, residual causal self_attention, layer_norm, residual
    gelu ffn of ratio 4], then a softmax head of ``classes``."""
    block = [{"type": "layer_norm"},
             {"type": "self_attention", "heads": heads, "causal": True,
              "residual": True},
             {"type": "layer_norm"},
             {"type": "ffn", "ratio": 4, "activation": "gelu",
              "residual": True}]
    return block * depth + [{"type": "softmax",
                             "output_sample_shape": classes}]


def build_transformer(device, data, labels, layers, class_lengths,
                      minibatch, epochs, lr, sweep=True, weights=None,
                      fused="auto"):
    """A StandardWorkflow over (N, T, E) samples at precision level 0
    with the GEMM knobs off (seeds 1234, no normalization, learning rate
    ``lr``, moment 0.9), in the fused tick or (``fused=False``) graph
    mode; ``weights`` (per-layer numpy dicts) are put into the units
    before initialize()."""
    root.common.engine.update({"use_pallas": False,
                               "pallas_epilogue": False,
                               "precision_level": 0})
    prng.get("default").seed(1234)
    prng.get("loader").seed(1234)
    wf = StandardWorkflow(
        DummyLauncher(), layers=layers,
        loader_kwargs=dict(data=data, labels=labels,
                           class_lengths=class_lengths,
                           minibatch_size=minibatch,
                           normalization_type="none"),
        learning_rate=lr, gradient_moment=0.9,
        decision_kwargs=dict(max_epochs=epochs), fused_sweep=sweep,
        fused=fused, device=device, name="transformer")
    if weights is not None:
        unit_params_from_jax(wf, weights)
    return wf


def report_tokens(label, wf, epochs, wall, t):
    """Print tokens/s over the whole run (every trained and evaluated
    sequence's positions), the per-epoch train loss and validation
    n_err; fail on a non-finite loss."""
    _, valid, train_mb = minibatch_counts(wf)
    minibatch = wf.loader.max_minibatch_size
    tokens = (valid + train_mb) * minibatch * t
    losses = [e["train_loss"] for e in epochs]
    print("train %s: %d epochs in %.3f s, %.1f tokens/s over the whole "
          "run (%d tokens); train loss %s; validation n_err %s; "
          "minibatches per class (test, valid, train) %s"
          % (label, len(epochs), wall, tokens / wall, tokens,
             ["%.6f" % v for v in losses], [e["valid_n_err"] for e in epochs],
             minibatch_counts(wf)))
    if not all(math.isfinite(v) for v in losses):
        raise AssertionError("%s: a train loss is not finite" % label)


def longctx_training_phase(device):
    """The long-context training main path: transformer_device's stack at
    longctx_device's width (embed 1024, 8 heads of 128, 8192 positions),
    16 samples from RandomState(0).randn, 2 epochs, minibatch 1. The
    counters, zeroed before the run, must read K7 4 per train and valid
    minibatch (one per block) and K8 and K9 4 per train minibatch,
    nothing else. Returns the launches and the run's wall seconds."""
    rng = numpy.random.RandomState(0)
    data = rng.randn(LONG_SAMPLES, LONG_T, EMBED).astype(numpy.float32)
    labels = split_labels(rng, LONG_CLASSES, LONG_CLASS_LENGTHS)
    wf = build_transformer(device, data, labels,
                           transformer_layers(LONG_HEADS, LONG_CLASSES,
                                              BLOCKS),
                           LONG_CLASS_LENGTHS, 1, LONG_EPOCHS, LONG_LR)
    for fn in COUNTERS.values():
        fn.launches = 0
    epochs, wall = train(wf, device)
    got = counts()
    report_tokens("long-context 4 x [LN, attention 8x128 causal, LN, ffn "
                  "gelu x4] + softmax 16, T %d, mb 1" % LONG_T, wf, epochs,
                  wall, LONG_T)
    _, valid, train_mb = wf.fused_tick.minibatch_counts
    per_epoch = LONG_CLASS_LENGTHS[1] + LONG_CLASS_LENGTHS[2]
    want = dict.fromkeys(COUNTERS, 0)
    want.update(flash_attention_fwd=LONG_EPOCHS * per_epoch * BLOCKS,
                flash_attention_dkv=LONG_EPOCHS * LONG_CLASS_LENGTHS[2]
                * BLOCKS,
                flash_attention_dq=LONG_EPOCHS * LONG_CLASS_LENGTHS[2]
                * BLOCKS)
    print("  launches %s (expected: K7 %d epochs x %d minibatches x %d "
          "blocks, K8 = K9 %d x %d train x %d)"
          % ({k: v for k, v in got.items() if v}, LONG_EPOCHS, per_epoch,
             BLOCKS, LONG_EPOCHS, LONG_CLASS_LENGTHS[2], BLOCKS))
    if got != want or len(epochs) != LONG_EPOCHS \
            or valid + train_mb != LONG_EPOCHS * per_epoch:
        raise AssertionError("long-context run: %d epochs, minibatches %s, "
                             "launches %s, expected %s"
                             % (len(epochs), wf.fused_tick.minibatch_counts,
                                got, want))
    return got, wall


def transformer_device_phase(device):
    """transformer_device at its own full width (batch 16, 512 positions,
    embed 1024, 16 heads of 64, 4 blocks, 256 classes; 64 samples, 16
    valid / 48 train), 2 epochs: the plain attention route, so no kernel
    may launch."""
    rng = numpy.random.RandomState(0)
    n = sum(TD_CLASS_LENGTHS)
    data = rng.randn(n, TD_T, EMBED).astype(numpy.float32)
    labels = split_labels(rng, TD_CLASSES, TD_CLASS_LENGTHS)
    wf = build_transformer(device, data, labels,
                           transformer_layers(TD_HEADS, TD_CLASSES, BLOCKS),
                           TD_CLASS_LENGTHS, TD_MINIBATCH, TD_EPOCHS, TD_LR)
    for fn in COUNTERS.values():
        fn.launches = 0
    epochs, wall = train(wf, device)
    got = counts()
    report_tokens("transformer_device 4 x [LN, attention 16x64 causal, LN, "
                  "ffn gelu x4] + softmax 256, T %d, mb %d"
                  % (TD_T, TD_MINIBATCH), wf, epochs, wall, TD_T)
    print("  launches %s (expected none)"
          % {k: v for k, v in got.items() if v})
    if any(got.values()) or len(epochs) != TD_EPOCHS:
        raise AssertionError("transformer_device: %d epochs, launches %s"
                             % (len(epochs), got))


def agreement_weights(rng, layers, t, embed):
    """Per-layer numpy leaves for ``layers``: projections U(+-1/sqrt(fan_in))
    as the units draw them, layer-norm scales 1 + U(+-0.1), every bias and
    shift U(+-0.1) (non-zero, so each leaf's tolerance is relative to a
    real magnitude)."""
    def uniform(bound, *shape):
        return rng.uniform(-bound, bound, shape).astype(numpy.float32)

    weights, hidden = [], 4 * embed
    for spec in layers:
        kind = spec["type"]
        if kind == "layer_norm":
            leaves = {"weights": 1 + uniform(0.1, embed),
                      "bias": uniform(0.1, embed)}
        elif kind == "self_attention":
            leaves = {"weights": uniform(embed ** -0.5, embed, 3 * embed),
                      "bias": uniform(0.1, 3 * embed),
                      "out_weights": uniform(embed ** -0.5, embed, embed),
                      "out_bias": uniform(0.1, embed)}
        elif kind == "ffn":
            leaves = {"weights": uniform(embed ** -0.5, embed, hidden),
                      "bias": uniform(0.1, hidden),
                      "out_weights": uniform(hidden ** -0.5, hidden, embed),
                      "out_bias": uniform(0.1, embed)}
        else:
            fan_in = t * embed
            leaves = {"weights": uniform(fan_in ** -0.5, fan_in,
                                         spec["output_sample_shape"]),
                      "bias": uniform(0.1, spec["output_sample_shape"])}
        weights.append(leaves)
    return weights


def long_training_agreement_phase(device):
    """One epoch of one pre-LN block at 4096 positions, embed 256, 2 heads
    of 128, level 0, per-minibatch ticks, on the card (K7, K8, K9) and on
    the CPU (the plain route), from the same numpy weights: equal index
    streams, equal per-minibatch n_err, every leaf's update within
    AGREE_LONG_RTOL of its largest element."""
    rng = numpy.random.RandomState(7)
    n = sum(AGREE_LONG_CLASS_LENGTHS)
    data = rng.randn(n, AGREE_T, AGREE_EMBED).astype(numpy.float32)
    labels = split_labels(rng, LONG_CLASSES, AGREE_LONG_CLASS_LENGTHS)
    layers = transformer_layers(AGREE_HEADS, LONG_CLASSES, depth=1)
    weights = agreement_weights(rng, layers, AGREE_T, AGREE_EMBED)
    results = []
    for dev in (device, torch.device("cpu")):
        wf = build_transformer(dev, data, labels, layers,
                               AGREE_LONG_CLASS_LENGTHS, 1, 1, AGREE_LONG_LR,
                               sweep=False, weights=weights)
        served, n_errs, got, wall = recorded_run(wf)
        leaves = [{name: getattr(f, name).data.cpu() for name in
                   ("weights", "bias", "out_weights", "out_bias")
                   if hasattr(f, name)} for f in wf.forwards]
        results.append((served, n_errs, leaves, got, wall))
    (served_c, errs_c, w_c, got_c, wall_c), \
        (served_h, errs_h, w_h, got_h, wall_h) = results
    same_stream = len(served_c) == len(served_h) and all(
        numpy.array_equal(a, b) for a, b in zip(served_c, served_h))
    worst, where, weights_rel = 0.0, None, 0.0
    for i, (lc, lh, init) in enumerate(zip(w_c, w_h, weights)):
        for name, ref in lh.items():
            start = torch.from_numpy(init[name])
            moved = (ref - start).abs().max()
            rel = ((lc[name] - ref).abs().max() / moved).item()
            weights_rel = max(weights_rel, ((lc[name] - ref).abs().max()
                                            / ref.abs().max()).item())
            if rel >= worst:
                worst, where = rel, "layer %d %s" % (i, name)
    train_mb = AGREE_LONG_CLASS_LENGTHS[2]
    want_c = dict.fromkeys(COUNTERS, 0)
    want_c.update(flash_attention_fwd=n, flash_attention_dkv=train_mb,
                  flash_attention_dq=train_mb)
    print("training agreement long context (level 0, T %d, embed %d, %d "
          "heads of %d, 1 epoch, %d minibatches): index streams %s; n_err "
          "card %s, CPU %s; largest update difference %.3g of the leaf's "
          "largest update (%s; tolerance %.0e), largest weight difference "
          "%.3g of the leaf's largest weight; card launches %s in %.3f s, "
          "CPU launches %d in %.3f s"
          % (AGREE_T, AGREE_EMBED, AGREE_HEADS, AGREE_EMBED // AGREE_HEADS,
             len(served_c), "equal" if same_stream else "DIFFER", errs_c,
             errs_h, worst, where, AGREE_LONG_RTOL, weights_rel,
             {k: v for k, v in got_c.items() if v}, wall_c,
             sum(got_h.values()), wall_h))
    if not same_stream or errs_c != errs_h or not worst <= AGREE_LONG_RTOL:
        raise AssertionError("the card's long-context training disagrees "
                             "with the CPU's")
    if got_c != want_c or any(got_h.values()):
        raise AssertionError("the card run launched %s (expected %s) or the "
                             "CPU run launched a kernel" % (got_c, want_c))


class HostObserver(Unit):
    """bench.py:170-175's host unit: counts its firings, touches no slot;
    ``transparent`` says so to the sweep tier."""

    def __init__(self, workflow, transparent, **kwargs):
        super().__init__(workflow, **kwargs)
        self.sweep_transparent = transparent
        self.ticks = 0

    def run(self):
        self.ticks += 1


def splice_observer(wf, transparent):
    """A HostObserver between the two forwards (control links only), so
    the fused tick must decline the chain (bench.py:176-181)."""
    obs = HostObserver(wf, transparent, name="observer")
    fwd1 = wf.forwards[1]
    fwd1.unlink_from(wf.forwards[0])
    obs.link_from(wf.forwards[0])
    fwd1.link_from(obs)
    return obs


def engaged_tier(wf):
    """Which execution tier the workflow runs: "fused", "sweep",
    "segment" or "graph"."""
    if wf.fused_tick is not None:
        return "fused"
    if isinstance(wf.sweep_unit, FusedSweep):
        return "sweep"
    if any(isinstance(u, FusedSegment) for u in wf.units):
        return "segment"
    return "graph"


def composite_calls(wf):
    """The tier's composite firings: fused-tick steps, sweep chunks or
    segment calls (0 in graph mode)."""
    if wf.fused_tick is not None:
        return wf.fused_tick.ticks
    if wf.sweep_unit is not None:
        return wf.sweep_unit.chunk_calls
    return sum(u.calls for u in wf.units if isinstance(u, FusedSegment))


def tiers_phase(device):
    """The bench's graph-mode cliff (bench.py:150-230): the reference
    MNIST784 (784 -> 100 tanh -> 10, minibatch 100) on the bench data in
    graph mode (fused=False), the segment tier (a host unit the chain
    cannot fuse spliced between the forwards), the sweep tier (the same
    unit declared sweep_transparent) and the fused tick, TIER_EPOCHS
    each: images/s, unit firings and composite calls per epoch, and the
    tier that engaged, asserted as bench.py asserts it. Returns the
    images/s by tier."""
    data, labels = bench_dataset()
    rates = {}
    for tier in ("graph", "segment", "sweep", "fused"):
        wf = build_mlp(device, data, labels, MNIST_LAYERS, MNIST_MINIBATCH,
                       BENCH_CLASS_LENGTHS, False, TIER_EPOCHS,
                       fused=False if tier == "graph" else "auto")
        obs = splice_observer(wf, tier == "sweep") \
            if tier in ("segment", "sweep") else None
        epochs, wall = train(wf, device)
        if engaged_tier(wf) != tier:
            raise AssertionError("the %s run engaged the %s tier"
                                 % (tier, engaged_tier(wf)))
        losses = report_training("tiers: %s, reference MNIST784" % tier, wf,
                                 epochs, wall, len(data))
        rates[tier] = len(data) * len(epochs) / wall
        # every unit's firings (Unit.run_calls), the splices' included
        per_epoch = [sum(u.run_calls for u in wf.units) / len(epochs),
                     composite_calls(wf) / len(epochs)]
        print("  tier %s engaged: %.1f images/s over the run, %.1f unit "
              "firings and %.1f composite calls per epoch%s"
              % (tier, rates[tier], per_epoch[0], per_epoch[1],
                 ", observer fired %d times" % obs.ticks if obs else ""))
        ticks = sum(minibatch_counts(wf))
        if len(epochs) != TIER_EPOCHS or not losses[-1] < losses[0] \
                or (obs is not None and obs.ticks != ticks):
            raise AssertionError("tier %s: %d epochs, losses %s, observer "
                                 "%s of %d ticks" % (tier, len(epochs),
                                                     losses, obs and
                                                     obs.ticks, ticks))
        del wf
    print("tiers (images/s over the run): %s" % json.dumps(rates))
    return rates


def graph_mlp_phase(device):
    """The wide MLP (784 -> 4096 tanh -> 10, minibatch 4096, level 0) in
    graph mode, GRAPH_EPOCHS epochs, with the kernel knobs on (K5 on the
    hidden layer's forward on every minibatch and its weight gradient
    and error product on every train minibatch: counted) and off (no
    kernel). Returns the knobs-on run's launches."""
    data, labels = bench_dataset()
    main = None
    for knobs in (True, False):
        wf = build_mlp(device, data, labels, WIDE_LAYERS, WIDE_MINIBATCH,
                       BENCH_CLASS_LENGTHS, knobs, GRAPH_EPOCHS,
                       fused=False)
        for fn in COUNTERS.values():
            fn.launches = 0
        epochs, wall = train(wf, device)
        got = counts()
        report_training("graph mode wide MLP 784-4096-10 mb 4096, knobs "
                        "%s" % ("on" if knobs else "off"), wf, epochs, wall,
                        len(data))
        _, valid, train_mb = minibatch_counts(wf)
        want = dict.fromkeys(COUNTERS, 0)
        if knobs:
            want["blocked_matmul"] = 3 * train_mb + valid
            main = got
        print("  tier %s; launches %s, K5 %.1f per epoch (graph mode's "
              "minibatches require %s)"
              % (engaged_tier(wf), {k: v for k, v in got.items() if v},
                 got["blocked_matmul"] / max(len(epochs), 1),
                 {k: v for k, v in want.items() if v}))
        if got != want or len(epochs) != GRAPH_EPOCHS \
                or engaged_tier(wf) != "graph":
            raise AssertionError("graph-mode wide MLP: %d epochs, launches "
                                 "%s, expected %s"
                                 % (len(epochs), got, want))
        del wf
    return main


def leaf_rel(a_leaves, b_leaves):
    """The largest |a - b| of any leaf over that leaf's largest |b|."""
    return max(((a - b).abs().max() / b.abs().max().clamp(min=1e-30)).item()
               for a, b in zip(a_leaves, b_leaves))


def mlp_leaves(wf):
    return [getattr(f, name).data.float().cpu() for f in wf.forwards
            for name in ("weights", "bias")]


def graph_agreement_phase(device):
    """One epoch of the wide MLP at level 2 (f32), per-minibatch serving,
    from the same numpy weights (the training agreement's data): graph
    mode on the card against the fused tick on the card (K6 and K5
    there, K5 in graph mode) and against graph mode on the CPU (plain
    versions): equal index streams, per-minibatch n_err within
    AGREE_N_ERR_TOL, every leaf within GRAPH_LEAF_RTOL of its largest
    element."""
    data, labels = bench_dataset()
    n = sum(AGREE_CLASS_LENGTHS)
    data, labels = data[:n], labels[:n]
    rng = numpy.random.RandomState(5)
    weights, fan_in = [], data.shape[1]
    for width in WIDE_LAYERS:
        bound = 1.0 / math.sqrt(fan_in)
        weights.append({
            "weights": rng.uniform(-bound, bound, (fan_in, width)),
            "bias": rng.uniform(-bound, bound, width)})
        fan_in = width
    runs = {}
    for label, dev, fused in (("graph card", device, False),
                              ("fused card", device, True),
                              ("graph CPU", torch.device("cpu"), False)):
        wf = build_mlp(dev, data, labels, WIDE_LAYERS, WIDE_MINIBATCH,
                       AGREE_CLASS_LENGTHS, True, 1, precision_level=2,
                       sweep=False, weights=weights, fused=fused)
        served, n_errs, got, wall = recorded_run(wf)
        runs[label] = (served, n_errs, mlp_leaves(wf), got, wall)
    base = runs["graph card"]
    for other in ("fused card", "graph CPU"):
        ref = runs[other]
        same = len(base[0]) == len(ref[0]) and all(
            numpy.array_equal(a, b) for a, b in zip(base[0], ref[0]))
        diff = max(abs(a - b) for a, b in zip(base[1], ref[1]))
        rel = leaf_rel(base[2], ref[2])
        print("graph agreement f32 (level 2), 1 epoch, %d minibatches, "
              "graph card against %s: index streams %s; n_err %s against "
              "%s (max diff %d, tolerance %d); largest leaf difference %.3g "
              "of the leaf's largest element (tolerance %.0e); launches "
              "%s against %s"
              % (len(base[0]), other, "equal" if same else "DIFFER",
                 base[1], ref[1], diff, AGREE_N_ERR_TOL, rel,
                 GRAPH_LEAF_RTOL, {k: v for k, v in base[3].items() if v},
                 {k: v for k, v in ref[3].items() if v}))
        if not same or len(base[1]) != len(ref[1]) \
                or diff > AGREE_N_ERR_TOL or not rel <= GRAPH_LEAF_RTOL:
            raise AssertionError("graph mode on the card disagrees with %s"
                                 % other)
    if not base[3]["blocked_matmul"] or any(runs["graph CPU"][3].values()):
        raise AssertionError("the card's graph mode skipped K5 or the CPU "
                             "run launched a kernel")


def longctx_graph_phase(device):
    """The long-context stack of longctx_training_phase (embed 1024, 8
    heads of 128, 8192 positions, minibatch 1, 16 samples, LONG_LR) in
    graph mode, LONG_GRAPH_EPOCHS epoch(s): tokens/s and the flash
    launches, K7 per block on every minibatch (the forward unit) and
    again on every train minibatch (GDSelfAttention's autograd recomputes
    the forward), K8 and K9 per block per train minibatch. Returns the
    launches."""
    rng = numpy.random.RandomState(0)
    data = rng.randn(LONG_SAMPLES, LONG_T, EMBED).astype(numpy.float32)
    labels = split_labels(rng, LONG_CLASSES, LONG_CLASS_LENGTHS)
    wf = build_transformer(device, data, labels,
                           transformer_layers(LONG_HEADS, LONG_CLASSES,
                                              BLOCKS),
                           LONG_CLASS_LENGTHS, 1, LONG_GRAPH_EPOCHS,
                           LONG_LR, fused=False)
    for fn in COUNTERS.values():
        fn.launches = 0
    epochs, wall = train(wf, device)
    got = counts()
    report_tokens("graph mode long-context 4 x [LN, attention 8x128 causal, "
                  "LN, ffn gelu x4] + softmax 16, T %d, mb 1" % LONG_T, wf,
                  epochs, wall, LONG_T)
    valid, train_mb = (LONG_GRAPH_EPOCHS * n for n in LONG_CLASS_LENGTHS[1:])
    want = dict.fromkeys(COUNTERS, 0)
    want.update(flash_attention_fwd=(valid + 2 * train_mb) * BLOCKS,
                flash_attention_dkv=train_mb * BLOCKS,
                flash_attention_dq=train_mb * BLOCKS)
    print("  tier %s; launches %s (expected: K7 (%d valid + 2 x %d train) "
          "x %d blocks, K8 = K9 %d train x %d)"
          % (engaged_tier(wf), {k: v for k, v in got.items() if v}, valid,
             train_mb, BLOCKS, train_mb, BLOCKS))
    if got != want or len(epochs) != LONG_GRAPH_EPOCHS \
            or engaged_tier(wf) != "graph":
        raise AssertionError("graph-mode long context: %d epochs, launches "
                             "%s, expected %s" % (len(epochs), got, want))
    return got


def long_graph_agreement_phase(device):
    """One epoch of one pre-LN block at 4096 positions (the long-context
    agreement's shapes, level 0, per-minibatch ticks) on the card in
    graph mode and in the fused tick, from the same numpy weights: equal
    index streams and per-minibatch n_err, every leaf's update within
    AGREE_LONG_RTOL of its largest element; graph mode's launches K7 on
    every minibatch and again on every train one, K8 and K9 on every
    train one."""
    rng = numpy.random.RandomState(7)
    n = sum(AGREE_LONG_CLASS_LENGTHS)
    data = rng.randn(n, AGREE_T, AGREE_EMBED).astype(numpy.float32)
    labels = split_labels(rng, LONG_CLASSES, AGREE_LONG_CLASS_LENGTHS)
    layers = transformer_layers(AGREE_HEADS, LONG_CLASSES, depth=1)
    weights = agreement_weights(rng, layers, AGREE_T, AGREE_EMBED)
    results = []
    for fused in (False, True):
        wf = build_transformer(device, data, labels, layers,
                               AGREE_LONG_CLASS_LENGTHS, 1, 1, AGREE_LONG_LR,
                               sweep=False, weights=weights, fused=fused)
        served, n_errs, got, _ = recorded_run(wf)
        leaves = [{name: getattr(f, name).data.cpu() for name in
                   ("weights", "bias", "out_weights", "out_bias")
                   if hasattr(f, name)} for f in wf.forwards]
        results.append((served, n_errs, leaves, got))
    (served_g, errs_g, w_g, got_g), (served_f, errs_f, w_f, _) = results
    same = len(served_g) == len(served_f) and all(
        numpy.array_equal(a, b) for a, b in zip(served_g, served_f))
    worst, where = 0.0, None
    for i, (lg, lf, init) in enumerate(zip(w_g, w_f, weights)):
        for name, ref in lf.items():
            moved = (ref - torch.from_numpy(init[name])).abs().max()
            rel = ((lg[name] - ref).abs().max() / moved).item()
            if rel >= worst:
                worst, where = rel, "layer %d %s" % (i, name)
    train_mb = AGREE_LONG_CLASS_LENGTHS[2]
    want = dict.fromkeys(COUNTERS, 0)
    want.update(flash_attention_fwd=n + train_mb,
                flash_attention_dkv=train_mb, flash_attention_dq=train_mb)
    print("long-context graph agreement (level 0, T %d, embed %d, %d heads "
          "of %d, 1 epoch, %d minibatches), graph mode against the fused "
          "tick on the card: index streams %s; n_err %s against %s; largest "
          "update difference %.3g of the leaf's largest update (%s; "
          "tolerance %.0e); graph-mode launches %s"
          % (AGREE_T, AGREE_EMBED, AGREE_HEADS, AGREE_EMBED // AGREE_HEADS,
             len(served_g), "equal" if same else "DIFFER", errs_g, errs_f,
             worst, where, AGREE_LONG_RTOL,
             {k: v for k, v in got_g.items() if v}))
    if not same or errs_g != errs_f or not worst <= AGREE_LONG_RTOL \
            or got_g != want:
        raise AssertionError("graph mode's long-context training disagrees "
                             "with the fused tick's (launches %s, expected "
                             "%s)" % (got_g, want))


def som_run(device, data, epochs, step_hook=None):
    """KohonenWorkflow (SOM_SHAPE, minibatch SOM_MINIBATCH) over ``data``
    for ``epochs`` epochs from the seeded streams; ``step_hook(trainer,
    weights, batch)`` is called after each step with the weights before
    it. Returns the workflow, each step's quantization error (a device
    scalar) and the wall seconds of run() (the card synchronised)."""
    prng.get("kohonen").seed(1234)
    prng.get("loader").seed(1234)
    wf = KohonenWorkflow(
        DummyLauncher(), shape=SOM_SHAPE, device=device,
        loader_kwargs=dict(data=data, class_lengths=[0, 0, len(data)],
                           minibatch_size=SOM_MINIBATCH),
        max_epochs=epochs, name="som")
    wf.initialize()
    trainer = wf.trainer
    errors = []
    real = trainer.run

    def recorded():
        before, batch = trainer.weights.data, trainer.input.data
        real()
        errors.append(trainer.quantization_error)
        if step_hook is not None:
            step_hook(trainer, before, batch)

    trainer.run = recorded
    if device.type == "cuda":
        torch.cuda.synchronize()
    t0 = time.perf_counter()
    wf.run()
    if device.type == "cuda":
        torch.cuda.synchronize()
    return wf, errors, time.perf_counter() - t0


def som_phase(device):
    """The Kohonen SOM (BASELINE.json config 4) at samples/som_digits.py's
    defaults over the bench's 60000 x 784 pixels (uniform in [0, 1): the
    card's machine has no sklearn, and the digits file is not in the
    repository), SOM_EPOCHS epochs: steps/s and the mean quantization
    error of each epoch, which must fall; then one epoch on the card, each
    step also run on the CPU from the card's weights and minibatch (see
    SOM_TIE_GAP). Returns the steps/s."""
    data, _ = bench_dataset()
    wf, errors, wall = som_run(device, data, SOM_EPOCHS)
    per_epoch = len(errors) // SOM_EPOCHS
    means = [float(torch.stack(errors[i * per_epoch:(i + 1) * per_epoch])
                   .mean()) for i in range(SOM_EPOCHS)]
    print("Kohonen SOM %s grid, mb %d, %d x %d samples, %d epochs: %d steps "
          "in %.3f s, %.1f steps/s, %.1f samples/s; mean quantization error "
          "per epoch %s" % (SOM_SHAPE, SOM_MINIBATCH, len(data),
                            data.shape[1], SOM_EPOCHS, len(errors), wall,
                            len(errors) / wall, len(data) * SOM_EPOCHS / wall,
                            ["%.6f" % e for e in means]))
    if wf.gather_results()["epochs"] != SOM_EPOCHS \
            or not all(math.isfinite(e) for e in means) \
            or not means[-1] < means[0]:
        raise AssertionError("the SOM's quantization error did not fall: "
                             "%s" % means)
    tally = {"steps": 0, "winners": 0, "resolved": 0, "ties": 0,
             "tie_flips": 0, "compared": 0, "rel": 0.0, "bad": 0}
    coords = None

    def compare(trainer, before, batch):
        nonlocal coords
        if coords is None:
            coords = grid_coords(trainer.shape, torch.device("cpu"))
        x = batch.reshape(batch.shape[0], -1).cpu()
        w = before.cpu()
        lr, sigma = trainer.last_rates
        new_w, winners, _ = som_step(w, x, lr.cpu(), sigma.cpu(), coords)
        card = trainer.winners.data.cpu()
        x64, w64 = x.double(), w.double()
        d2 = ((x64 * x64).sum(1)[:, None] - 2 * x64 @ w64.T
              + (w64 * w64).sum(1)[None, :])
        top2 = d2.topk(2, dim=1, largest=False).values
        resolved = (top2[:, 1] - top2[:, 0]) > SOM_TIE_GAP
        equal = card == winners
        tally["steps"] += 1
        tally["winners"] += len(card)
        tally["resolved"] += int(resolved.sum())
        tally["ties"] += int((~resolved).sum())
        tally["tie_flips"] += int((~equal & ~resolved).sum())
        tally["bad"] += int((~equal & resolved).sum())
        if bool(equal.all()):
            ref = new_w
            rel = ((trainer.weights.data.cpu() - ref).abs().max()
                   / ref.abs().max()).item()
            tally["compared"] += 1
            tally["rel"] = max(tally["rel"], rel)

    _, _, wall_c = som_run(device, data, 1, compare)
    print("Kohonen agreement f32, 1 epoch, each CPU step from the card's "
          "weights: %d steps; winners: %d, %d with a float64 top-2 gap above "
          "%.0e, all equal: %s (%d flipped there); %d near ties, %d flipped; "
          "new weights of the %d steps with every winner equal within %.3g "
          "of the largest (tolerance %.0e); %.3f s"
          % (tally["steps"], tally["winners"], tally["resolved"], SOM_TIE_GAP,
             tally["bad"] == 0, tally["bad"], tally["ties"],
             tally["tie_flips"], tally["compared"], tally["rel"],
             SOM_WEIGHT_RTOL, wall_c))
    if tally["bad"] or not tally["compared"] \
            or not tally["rel"] <= SOM_WEIGHT_RTOL:
        raise AssertionError("the card's SOM disagrees with the CPU's")
    return len(errors) / wall

def write_idx(path, array):
    """An idx file of uint8 ``array`` (gzipped where the name ends in
    .gz): the big-endian header, then the payload."""
    header = struct.pack(">HBB", 0, 0x08, array.ndim) + struct.pack(
        ">" + "I" * array.ndim, *array.shape)
    opener = gzip.open if path.endswith(".gz") else open
    with opener(path, "wb") as fout:
        fout.write(header + array.astype(numpy.uint8).tobytes())


def mnist_files(directory):
    """MNIST's four idx files from the bench data (70000 rows: its 10000-
    row valid block the t10k set, the 60000 behind it the train set),
    pixels times 255 rounded to uint8, two of the files gzipped. Returns
    the (test, train) pixels and labels as written."""
    data, labels = bench_dataset(n=MNIST_ROWS, n_valid=MNIST_TEST)
    pixels = numpy.rint(data * 255).astype(numpy.uint8).reshape(-1, 28, 28)
    parts = {"t10k": (pixels[:MNIST_TEST], labels[:MNIST_TEST]),
             "train": (pixels[MNIST_TEST:], labels[MNIST_TEST:])}
    for prefix, (images, labs) in parts.items():
        for kind, array in (("images-idx3", images), ("labels-idx1", labs)):
            name = "%s-%s-ubyte" % (prefix, kind)
            if name in MNIST_GZIPPED:
                name += ".gz"
            write_idx(os.path.join(directory, name), array)
    return parts


def build_mnist(device, directory, epochs, shuffle_limit=None):
    """samples/mnist784.py's configuration through the port's
    MLPWorkflow(loader_cls=MNISTLoader): 784 -> 100 tanh -> 10, minibatch
    100, lr 0.03, moment 0.9, linear normalization, seeds 1234."""
    root.common.engine.update({"use_pallas": False,
                               "pallas_epilogue": False,
                               "precision_level": 0})
    prng.get("default").seed(1234)
    prng.get("loader").seed(1234)
    return MLPWorkflow(
        DummyLauncher(), layers=MNIST_LAYERS, loader_cls=MNISTLoader,
        loader_kwargs=dict(directory=directory, minibatch_size=MNIST_MINIBATCH,
                           normalization_type="linear",
                           shuffle_limit=shuffle_limit),
        learning_rate=TRAIN_LR, gradient_moment=MNIST_MOMENT,
        max_epochs=epochs, device=device, name="MNIST784")


def mnist_phase(device, directory):
    """MNIST784 through its idx loader (samples/mnist784.py's workflow):
    the loader's arrays must equal the written bytes, its class lengths
    [0, 10000, 60000], and the train loss must fall over MNIST_EPOCHS
    epochs in the fused tick. Prints images/s and the validation errors
    per epoch."""
    parts = mnist_files(directory)
    wf = build_mnist(device, directory, MNIST_EPOCHS)
    epochs, wall = train(wf, device)
    loader = wf.loader
    images = numpy.concatenate([parts["t10k"][0], parts["train"][0]])
    labels = numpy.concatenate([parts["t10k"][1], parts["train"][1]])
    same = (numpy.array_equal(loader.original_data.data.cpu().numpy(),
                              images.reshape(len(images), -1).astype(
                                  numpy.float32))
            and numpy.array_equal(loader.original_labels.data.cpu().numpy(),
                                  labels))
    print("MNIST784 idx files (%s gzipped): class lengths %s, arrays equal "
          "the written bytes: %s, on %s"
          % (", ".join(MNIST_GZIPPED), loader.class_lengths, same,
             loader.original_data.data.device))
    losses = report_training("MNIST784 via MNISTLoader 784-100-10 mb 100, "
                             "moment 0.9, fused tick", wf, epochs, wall,
                             len(images))
    if not same or loader.class_lengths != [0, MNIST_TEST,
                                            MNIST_ROWS - MNIST_TEST] \
            or wf.fused_tick is None or len(epochs) != MNIST_EPOCHS \
            or not losses[-1] < losses[0]:
        raise AssertionError("MNIST784 through its loader failed")
    return len(images) * len(epochs) / wall


def build_regression(device, data, targets, class_lengths, knobs, epochs,
                     precision_level=0, sweep=True, weights=None,
                     fused="auto"):
    """The wide MLP regressed: MLPWorkflow(evaluator="mse") over
    FullBatchLoaderMSE (its default), the targets one-hot float32 with no
    target normalization, as build_mlp builds the classifier."""
    root.common.engine.update({"use_pallas": knobs,
                               "pallas_epilogue": knobs,
                               "precision_level": precision_level})
    prng.get("default").seed(1234)
    prng.get("loader").seed(1234)
    wf = MLPWorkflow(
        DummyLauncher(), layers=WIDE_LAYERS, evaluator="mse",
        loader_kwargs=dict(data=data, targets=targets,
                           class_lengths=class_lengths,
                           minibatch_size=WIDE_MINIBATCH,
                           normalization_type="linear",
                           target_normalization_type="none"),
        learning_rate=TRAIN_LR, max_epochs=epochs, fused_sweep=sweep,
        fused=fused, device=device, name="mse")
    if weights is not None:
        unit_params_from_jax(wf, weights)
    return wf


def one_hot(labels, classes=10):
    return numpy.eye(classes, dtype=numpy.float32)[labels]


def report_mse(label, wf, epochs, wall, n_images):
    """report_training's line for the regression family: train and
    validation MSE per epoch and the best validation MSE."""
    losses = report_training(label, wf, epochs, wall, n_images)
    valid = [e["valid_mse"] for e in epochs]
    print("  validation MSE per epoch %s; best %.6f (epoch %d)"
          % (["%.6f" % v for v in valid],
             wf.decision.best_mse[VALID], wf.decision.best_epoch))
    if not all(math.isfinite(v) for v in valid):
        raise AssertionError("%s: a validation MSE is not finite" % label)
    return losses


def mse_phase(device):
    """The wide MLP regressed on the bench data (one-hot targets),
    MSE_EPOCHS epochs in the fused tick with the knobs on, off, off and
    on: with the knobs on the counters (zeroed before each run) must
    show K6 once per train and eval minibatch and K5 once per train
    minibatch (the main path), with them off no kernel, and the train
    MSE must fall. Returns the first knobs-on run's launches."""
    data, labels = bench_dataset()
    targets = one_hot(labels)
    main = None
    for knobs in (True, False, False, True):
        wf = build_regression(device, data, targets, BENCH_CLASS_LENGTHS,
                              knobs, MSE_EPOCHS)
        for fn in COUNTERS.values():
            fn.launches = 0
        epochs, wall = train(wf, device)
        got = counts()
        losses = report_mse("wide MLP regressed (MSE) 784-4096-10 mb 4096, "
                            "knobs %s" % ("on" if knobs else "off"), wf,
                            epochs, wall, len(data))
        test, valid, train_mb = wf.fused_tick.minibatch_counts
        want = dict.fromkeys(COUNTERS, 0)
        if knobs:
            want.update(dense_epilogue=test + valid + train_mb,
                        blocked_matmul=train_mb)
            main = main or got
        print("  launches %s (the tick's minibatches require %s)"
              % ({k: v for k, v in got.items() if v},
                 {k: v for k, v in want.items() if v}))
        if got != want or len(epochs) != MSE_EPOCHS \
                or wf.fused_tick._loss_kind_ != "mse" \
                or not losses[-1] < losses[0]:
            raise AssertionError("wide MLP regressed: %d epochs, MSE %s, "
                                 "launches %s, expected %s"
                                 % (len(epochs), losses, got, want))
        del wf
    return main


def mse_tiers_phase(device):
    """The wide MLP regressed for one epoch each, knobs on, in graph mode
    (fused=False), in the sweep tier (a sweep-transparent host unit
    spliced between the forwards) and in the segment tier (the same unit
    opaque): the tier that engages is asserted; images/s."""
    data, labels = bench_dataset()
    targets = one_hot(labels)
    rates = {}
    for tier in ("graph", "sweep", "segment"):
        wf = build_regression(device, data, targets, BENCH_CLASS_LENGTHS,
                              True, 1,
                              fused=False if tier == "graph" else "auto")
        obs = splice_observer(wf, tier == "sweep") \
            if tier != "graph" else None
        for fn in COUNTERS.values():
            fn.launches = 0
        epochs, wall = train(wf, device)
        got = counts()
        if engaged_tier(wf) != tier:
            raise AssertionError("the MSE %s run engaged the %s tier"
                                 % (tier, engaged_tier(wf)))
        report_mse("MSE tiers: %s, wide MLP regressed, knobs on" % tier, wf,
                   epochs, wall, len(data))
        rates[tier] = len(data) * len(epochs) / wall
        print("  tier %s engaged: %.1f images/s over the run, %.1f "
              "composite calls; launches %s%s"
              % (tier, rates[tier], composite_calls(wf),
                 {k: v for k, v in got.items() if v},
                 ", observer fired %d times" % obs.ticks if obs else ""))
        if len(epochs) != 1 or not got["blocked_matmul"] \
                or (obs is not None and obs.ticks != sum(
                    minibatch_counts(wf))):
            raise AssertionError("MSE tier %s: %d epochs, launches %s"
                                 % (tier, len(epochs), got))
        del wf
    return rates


def mse_agreement_phase(device):
    """One epoch of the wide MLP regressed at precision level 2 (f32; K5
    and K6 on f32 operands) on the card and on the CPU, per-minibatch
    serving, from the same numpy weights (the training agreement's data):
    equal index streams, each class's loss within MSE_AGREE_RTOL
    relative, every weight leaf within MSE_AGREE_RTOL of its largest
    element."""
    data, labels = bench_dataset()
    n = sum(AGREE_CLASS_LENGTHS)
    data, targets = data[:n], one_hot(labels[:n])
    rng = numpy.random.RandomState(5)
    weights, fan_in = [], data.shape[1]
    for width in WIDE_LAYERS:
        bound = 1.0 / math.sqrt(fan_in)
        weights.append({
            "weights": rng.uniform(-bound, bound, (fan_in, width)),
            "bias": rng.uniform(-bound, bound, width)})
        fan_in = width
    runs = []
    for dev in (device, torch.device("cpu")):
        wf = build_regression(dev, data, targets, AGREE_CLASS_LENGTHS, True,
                              1, precision_level=2, sweep=False,
                              weights=weights)
        served = []
        serve_next = wf.loader.serve_next_minibatch

        def recorded(serve_next=serve_next, served=served):
            block = serve_next()
            served.append(block[1])
            return block

        wf.loader.serve_next_minibatch = recorded
        for fn in COUNTERS.values():
            fn.launches = 0
        epochs, _ = train(wf, dev)
        runs.append((served, [(e["train_loss"], e["valid_mse"])
                              for e in epochs], mlp_leaves(wf), counts()))
    (served_c, loss_c, leaves_c, got_c), (served_h, loss_h, leaves_h,
                                          got_h) = runs
    same = len(served_c) == len(served_h) and all(
        numpy.array_equal(a, b) for a, b in zip(served_c, served_h))
    loss_rel = max(abs(a - b) / abs(b) for pc, ph in zip(loss_c, loss_h)
                   for a, b in zip(pc, ph))
    rel = leaf_rel(leaves_c, leaves_h)
    print("MSE agreement f32 (level 2), 1 epoch, %d minibatches: index "
          "streams %s; (train, valid) MSE card %s, CPU %s (largest relative "
          "difference %.3g, tolerance %.0e); largest leaf difference %.3g of "
          "the leaf's largest element (tolerance %.0e); card launches K5 %d, "
          "K6 %d; CPU launches %d"
          % (len(served_c), "equal" if same else "DIFFER", loss_c, loss_h,
             loss_rel, MSE_AGREE_RTOL, rel, MSE_AGREE_RTOL,
             got_c["blocked_matmul"], got_c["dense_epilogue"],
             sum(got_h.values())))
    if not same or len(loss_c) != 1 or len(loss_h) != 1 \
            or not loss_rel <= MSE_AGREE_RTOL or not rel <= MSE_AGREE_RTOL:
        raise AssertionError("the card's MSE training disagrees with the "
                             "CPU's")
    if not (got_c["blocked_matmul"] and got_c["dense_epilogue"]) \
            or any(got_h.values()):
        raise AssertionError("the card run skipped a kernel or the CPU run "
                             "launched one")


def normalizers_phase(device):
    """Each of the eight normalizers: analyze and apply_state on the
    bench's 60000 x 784 pixels on the card and on the CPU; the state and
    the output within NORM_RTOL of their largest element. Prints the
    card's and the CPU's seconds."""
    data, _ = bench_dataset()
    mean = data[:1000].mean(axis=0)
    for name in NORMALIZER_NAMES:
        kwargs = {"mean_source": mean} if name == "external_mean" else {}
        results = []
        for dev in (device, torch.device("cpu")):
            batch = torch.from_numpy(data).to(dev)
            if dev.type == "cuda":
                torch.cuda.synchronize()
            t0 = time.perf_counter()
            norm = make_normalizer(name, **kwargs)
            if not norm.STATELESS:
                norm.analyze(batch)
            state = norm.jit_state()
            out = norm.apply_state(batch, state_tensors(state, dev))
            if dev.type == "cuda":
                torch.cuda.synchronize()
            wall = time.perf_counter() - t0
            results.append((state, out.cpu(), wall))
        (state_c, out_c, wall_c), (state_h, out_h, wall_h) = results
        state_err = max([
            ((torch.as_tensor(state_c[k]).cpu().double()
              - torch.as_tensor(v).double()).abs().max()
             / max(torch.as_tensor(v).double().abs().max().item(), 1e-30)
             ).item() for k, v in state_h.items()] or [0.0])
        out_err = ((out_c - out_h).abs().max() / out_h.abs().max()).item()
        print("normalizer %s on %d x %d: state %s within %.3g, output within "
              "%.3g of its largest (tolerance %.0e); card %.4f s, CPU %.4f s"
              % (name, data.shape[0], data.shape[1], sorted(state_h),
                 state_err, out_err, NORM_RTOL, wall_c, wall_h))
        if sorted(state_c) != sorted(state_h) \
                or not torch.isfinite(out_c).all() \
                or not state_err <= NORM_RTOL or not out_err <= NORM_RTOL:
            raise AssertionError("normalizer %s: the card disagrees with "
                                 "the CPU" % name)


def write_wav(path, freq, rate=SOUND_RATE, seconds=1.0):
    """A 16-bit mono PCM tone; returns the samples written."""
    t = numpy.arange(int(rate * seconds)) / rate
    payload = (numpy.sin(2 * numpy.pi * freq * t) * 32000).astype(
        numpy.int16)
    with wave.open(path, "wb") as out:
        out.setnchannels(1)
        out.setsampwidth(2)
        out.setframerate(rate)
        out.writeframes(payload.tobytes())
    return payload


def loader_files_phase(device, directory):
    """The loaders' files: the first epoch of mnist_phase's loader with
    shuffling off (shuffle_limit=0) recorded by MinibatchesSaver and
    replayed through MinibatchesLoader, every minibatch equal bit for
    bit; PicklesLoader on pickles of the bench data and
    AutoLabelSoundFileLoader on WAV tones the smoke writes, their arrays
    equal to what was written."""
    wf = build_mnist(device, directory, 1, shuffle_limit=0)
    loader = wf.loader
    stream = os.path.join(directory, "minibatches.dat")
    saver = MinibatchesSaver(wf, file_name=stream, compression="raw")
    saver.link_attrs(loader, "minibatch_data", "minibatch_labels",
                     "minibatch_class", "minibatch_valid_size",
                     "class_lengths", "max_minibatch_size")
    loader.initialize()
    saver.initialize()
    recorded = []
    t0 = time.perf_counter()
    while True:
        loader.run()
        saver.run()
        recorded.append((loader.minibatch_data.mem.copy(),
                         loader.minibatch_labels.mem.copy()))
        if loader.epoch_ended:
            break
    saver.stop()
    wall_w = time.perf_counter() - t0
    replay = MinibatchesLoader(wf, file_name=stream,
                               minibatch_size=MNIST_MINIBATCH)
    replay.initialize()
    t0 = time.perf_counter()
    equal = True
    for data, labels in recorded:
        replay.run()
        equal = equal and (
            replay.minibatch_data.mem.tobytes() == data.tobytes()
            and replay.minibatch_labels.mem.tobytes() == labels.tobytes())
    replay.stop()
    wall_r = time.perf_counter() - t0
    print("minibatch stream: %d minibatches of %d (%d MB, raw) recorded in "
          "%.2f s, replayed through MinibatchesLoader on %s in %.2f s: bit "
          "for bit %s" % (len(recorded), MNIST_MINIBATCH,
                          os.path.getsize(stream) >> 20, wall_w,
                          replay.minibatch_data.data.device, wall_r, equal))
    if not equal or len(recorded) != (MNIST_ROWS // MNIST_MINIBATCH):
        raise AssertionError("the replayed minibatch stream differs")
    data, labels = bench_dataset()
    rows = {"validation": slice(0, PICKLE_VALID),
            "train": slice(PICKLE_VALID, PICKLE_VALID + PICKLE_TRAIN)}
    paths = {}
    for part, rows_of in rows.items():
        paths[part] = os.path.join(directory, part + ".pickle")
        with open(paths[part], "wb") as fout:
            pickle.dump((data[rows_of], labels[rows_of]), fout, protocol=4)
    pickles = PicklesLoader(
        wf, validation_pickles=[paths["validation"]],
        train_pickles=[paths["train"]], minibatch_size=WIDE_MINIBATCH)
    pickles.initialize()
    n = PICKLE_VALID + PICKLE_TRAIN
    same_pickles = (
        pickles.class_lengths == [0, PICKLE_VALID, PICKLE_TRAIN]
        and numpy.array_equal(pickles.original_data.data.cpu().numpy(),
                              data[:n])
        and numpy.array_equal(pickles.original_labels.data.cpu().numpy(),
                              labels[:n]))
    sound_dir = os.path.join(directory, "sound")
    written = {}
    for split, count in (("validation", 2), ("train", 6)):
        for label, freq in (("high", 1800), ("low", 200)):
            os.makedirs(os.path.join(sound_dir, split, label))
            for i in range(count):
                path = os.path.join(sound_dir, split, label, "%d.wav" % i)
                written[path] = write_wav(path, freq + 7 * i)
    sound = AutoLabelSoundFileLoader(
        wf, validation_paths=[os.path.join(sound_dir, "validation")],
        train_paths=[os.path.join(sound_dir, "train")],
        window_size=SOUND_WINDOW, minibatch_size=64)
    sound.initialize()
    windows, sound_labels = [], []
    for split in ("validation", "train"):
        for path in sorted(p for p in written if os.sep + split + os.sep
                           in p):
            samples = (written[path] / 32768.0).astype(numpy.float32)
            for start in range(0, len(samples) - SOUND_WINDOW + 1,
                               SOUND_WINDOW):
                windows.append(samples[start:start + SOUND_WINDOW])
                sound_labels.append(path.split(os.sep)[-2])
    mapping = sound.labels_mapping
    same_sound = (
        numpy.array_equal(sound.original_data.data.cpu().numpy(),
                          numpy.stack(windows))
        and numpy.array_equal(sound.original_labels.data.cpu().numpy(),
                              [mapping[s] for s in sound_labels]))
    print("PicklesLoader: %s rows from 2 pickles, arrays equal the written "
          "ones: %s; AutoLabelSoundFileLoader: %d WAV files, %d windows of "
          "%d, class lengths %s, labels %s, arrays equal the written "
          "samples: %s" % (pickles.class_lengths, same_pickles, len(written),
                           len(windows), SOUND_WINDOW, sound.class_lengths,
                           mapping, same_sound))
    if not same_pickles or not same_sound:
        raise AssertionError("a file loader's arrays differ from the "
                             "written files")


def main():
    if not torch.cuda.is_available():
        print("chip_smoke: no CUDA device available", file=sys.stderr)
        return 1
    device = torch.device("cuda")
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    print(card_line())
    print("torch %s, CUDA %s, %s x%d" % (
        torch.__version__, torch.version.cuda,
        torch.cuda.get_device_name(0), torch.cuda.device_count()))
    t0 = time.perf_counter()
    logs = _build.build()
    print("kernels built in %.1f s" % (time.perf_counter() - t0))
    for name, log in logs.items():
        for line in log.splitlines():
            if "registers" in line or "spill" in line:
                print("  %s: %s" % (name, line.strip()))
    for label, name in (("K1", "paged_attention"),
                        ("K3", "paged_attention_int8"),
                        ("K4", "cache_attend_int8")):
        spills = [tuple(map(int, m)) for m in re.findall(
            r"(\d+) bytes spill stores, (\d+) bytes spill loads",
            (_build.BUILD_DIR / (name + ".log")).read_text())]
        print("%s ptxas -v: %d functions, %d bytes of spill stores, %d of "
              "spill loads" % (label, len(spills),
                               sum(st for st, _ in spills),
                               sum(ld for _, ld in spills)))
    gen = torch.Generator(device=device)
    gen.manual_seed(0)
    timer = Timer(device)
    kernels = [k1_phase(timer, device, gen), k2_phase(timer, device, gen),
               k3_phase(timer, device, gen), k4_phase(timer, device, gen),
               k5_phase(timer, device, gen), k6_phase(timer, device, gen),
               *flash_phase(timer, device, gen)]
    wide = flash_wide_phase(timer, device, gen)
    for entry in kernels:
        key = entry["name"].replace("flash_attention_", "")
        if key in wide:
            entry["max_abs_err"] = max(entry["max_abs_err"], wide[key])
    prng = numpy.random.RandomState(1)
    prompts = [prng.randint(0, VOCAB, n).tolist()
               for n in numpy.linspace(60, 700, SLOTS).astype(int)]
    launches = serving_phase(device, prompts)
    for phase in (prefix_phase(device, prng), dense_phase(device)):
        for name, n in phase.items():
            launches[name] += n
    agreement_phase(device, prompts,
                    prefix_waves(numpy.random.RandomState(2)))
    narrow_heads_phase(device, prompts)
    sampling_phase(device, prompts)
    t_survival = time.perf_counter()
    for phase in (breaker_phase(device), swap_phase(device, prompts)):
        for name, n in phase.items():
            launches[name] += n
    print("survival phases (breaker, f32 agreement, hot swap): %.1f s"
          % (time.perf_counter() - t_survival))
    # the training path's kernels count on its main paths alone: the
    # wide MLP and AlexNet with the knobs on
    launches.update((name, n) for name, n in training_phase(device).items()
                    if name in ("blocked_matmul", "dense_epilogue"))
    training_agreement_phase(device)
    # graph mode and the lower fusion tiers: the wide MLP in graph mode
    # with the knobs on is a main path of K5
    tiers_phase(device)
    launches["blocked_matmul"] += graph_mlp_phase(device)["blocked_matmul"]
    graph_agreement_phase(device)
    alexnet = alexnet_phase(device)
    for name in ("blocked_matmul", "dense_epilogue"):
        launches[name] += alexnet[name]
    conv_agreement_phase(device)
    # the flash kernels count on their two main paths: the long-prompt
    # serving run (K7) and the long-context training run (K7, K8, K9)
    long_serving = long_serving_phase(device, numpy.random.RandomState(4))
    long_agreement_phase(device)
    long_training, long_wall = longctx_training_phase(device)
    kernel_ms = {entry["name"]: entry["ms"] for entry in kernels}
    in_kernels = 1e-3 * sum(kernel_ms[name] * long_training[name]
                            for name in FLASH)
    print("long-context training: K7-K9 account for about %.3f s of the "
          "run's %.3f s (%.1f%%: kernel-phase medians x launches), the "
          "rest %.3f s" % (in_kernels, long_wall,
                           100 * in_kernels / long_wall,
                           long_wall - in_kernels))
    transformer_device_phase(device)
    long_training_agreement_phase(device)
    # graph mode's long-context stack: a main path of K7, K8 and K9 too
    long_graph = longctx_graph_phase(device)
    long_graph_agreement_phase(device)
    for name in FLASH:
        launches[name] = (long_serving[name] + long_training[name]
                          + long_graph[name])
    som_phase(device)
    # the rest of the training surface: MNIST784 through its idx loader,
    # the regression family (its knobs-on wide MLP a main path of K5 and
    # K6), the normalizers and the file loaders
    t_a4 = time.perf_counter()
    with tempfile.TemporaryDirectory() as directory:
        mnist_phase(device, directory)
        mse = mse_phase(device)
        for name in ("blocked_matmul", "dense_epilogue"):
            launches[name] += mse[name]
        mse_tiers_phase(device)
        mse_agreement_phase(device)
        normalizers_phase(device)
        loader_files_phase(device, directory)
    print("training-surface phases (MNIST784 loader, MSE, normalizers, "
          "file loaders): %.1f s" % (time.perf_counter() - t_a4))
    for entry in kernels:
        entry["launches"] = launches[entry["name"]]
    print(json.dumps({"kernels": kernels}))
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": torch.cuda.get_device_name(0),
        "count": torch.cuda.device_count()}}))
    return 0


if __name__ == "__main__":
    sys.exit(main())
