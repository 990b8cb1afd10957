#!/usr/bin/env python3
"""Drive the PyTorch port (``src/repro_torch``) on one NVIDIA card.

    python3 chip_smoke.py        # from the repository root; needs one CUDA card

Phases, in order, each printing its own lines:

1. environment: the card's name and power limit, torch and CUDA versions;
   TF32 is switched off so the port is compared in full fp32;
2. build: nvcc builds every kernel of the main paths from ``src``, one
   process per source, all at once; the build times and the ``-Xptxas -v``
   register/spill lines are printed;
3. each kernel against its plain PyTorch version on the card, over a sweep
   of shapes and dtypes, plus the refusals its wrapper must make (a refused
   call launches nothing);
4. timing at the main paths' shapes: kernel, plain version, one library
   call as a yardstick, and the bound (CUDA events, L2 flushed by a read
   that leaves it holding clean lines); ``fedavg_aggregate`` also at the
   rounds of the char-LSTM, CIFAR CNN and word-LSTM (K = 115, 10, 51), at the
   buffered-async apply (K = buffer_k = 3, the 2NN's N) and at the Gemma-2B
   training leaves (11 bf16 launches of K = 2 a group average);
5. the plain lane, the paper's MNIST 2NN non-IID cell at full size through
   ``RoundEngine(...).run``: one round on the card is first held against
   the same round on the CPU, then the rounds are run and timed;
6. the same for the MNIST CNN;
7. where the time goes: one more round of each under torch.profiler,
   device time by kernel against the round's wall time;
8. the compressed-upload lane through ``RoundEngine(codec=...).run`` at full
   size: the 2NN with the q8, q4 (bit-packed), top-k and low-rank codecs
   of ``specs/mnist_2nn_noniid_{q8,topk,lowrank}.json``, the CNN with q8 and
   top-k. Each lane's kernel launches once a round; one round's payloads,
   recorded on the way, are aggregated again on the CPU by the plain
   versions and held against the card's aggregate, and their realized
   bytes against the wire-bytes table;
9. one profiled round of the CNN q8 lane: the kernel's share of the round;
10. a plain and a q8 CNN round in turns, so that the two lanes' round
    times are compared on one card at one time;
11. the gossip lane at full size through ``RoundEngine(topology=...).run``:
    the 2NN on the ring and small-world graphs of
    ``specs/mnist_2nn_noniid_{ring,smallworld}.json`` and the CNN on the
    ring, 100 nodes each. One gossip round on the card is first held
    against the same round on the CPU (same injected batches); then each
    lane runs, and ``gossip_mix`` must launch once a round;
12. the anchor: on the full graph (100 nodes, 2NN) one gossip round equals
    one plain FedAvg round with C = 1.0 on the same injected batches; its
    one ``gossip_mix`` launch must take the dense route;
13. one profiled CNN ring round: the mixing kernel's share and the card's
    idle share;
14. serving the LM substrate: Jamba (``jamba-v0.1-52b`` at full width, one
    period of 8 layers, bf16, weights drawn on the card from seed 0) takes
    one request of B = 4 prompts of 2048 tokens and greedy decode to 32
    tokens through ``repro_torch.launch.serve.generate``: ``flash_attention``
    must launch once (the attention layer's prefill) and ``ssm_scan`` 224
    times (7 Mamba layers in prefill and in each of 31 decode steps), each
    with the lanes a channel of its launch plan;
15. the same for Gemma-2B, all 18 layers: ``flash_attention`` 18 times;
16. correctness of the LM path: prefill + decode equals forward at full
    width in bf16 (both models), and the reduced configs in fp32 on the card
    against the CPU (Jamba, Gemma-2B, DeepSeek-V2-Lite and V3, Qwen2-VL,
    xLSTM, SeamlessM4T over 16 frames);
17. one profiled Jamba prefill and one decode step: device busy, idle
    share, the top ops and the two kernels' share;
18. training the LM substrate: Gemma-2B whole (18 layers, bf16, remat,
    weights drawn on the card from seed 0, tokens from ``make_word_corpus``)
    through ``repro_torch.launch.train.main``: 2 FedAvg rounds of G = 2
    groups x H = 2 local AdamW steps on 2 x 2048 tokens a group, each round
    launching ``fused_cross_entropy`` 4 times (all on its tensor-core
    route), ``ce_probs`` 16 times (4 chunks of 1,024 tokens a backward),
    ``flash_attention`` 144 times (forward and remat recompute of 18 layers
    in 4 steps) and ``fedavg_aggregate`` once a parameter leaf; then 4
    FedSGD steps; seconds, tokens/s, loss and peak memory a round;
19. correctness of training: a reduced-config FedAvg round in fp32 on the
    card against the CPU (Gemma-2B, Qwen2 and Jamba's 8 layers: attention,
    Mamba and MoE; xLSTM's mLSTM and sLSTM; SeamlessM4T's encoder and
    cross-attention over 24 frames; one step's gradients, SGD's update,
    AdamW's moments),
    ``train_loss``'s CE at full
    width against materialized fp32 logits, and FusedCrossEntropy's
    gradients against autograd through them;
20. one profiled Gemma-2B training step: device busy, idle share, the top
    kernels and the shares of the CE kernels (forward and ``ce_probs``), the
    flash kernel and the two backwards.
21. the spec front door and checkpoints: all 15 ``specs/*.json`` load
    through ``repro_torch.specs`` and run at full size, 1 round each (2 for
    FedAvgM, the ring and the small world; 3 applies for the two
    buffered-async specs, ``fedavg_aggregate`` once an apply, whose ``sim_s``
    sequence must equal, float for float, the same spec's schedule run by
    the port on the CPU after the card's lanes, its client and apply phases
    stood in for by zeros of their shapes) through
    ``RoundEngine.from_spec(spec, clients, eval_fn=...).run`` on the
    partition the spec builds (``shakespeare_lstm``: the 1146 roles of
    ``make_char_corpus()`` cut into windows of 80, 115 a round, 275 masked
    steps, evaluated on every role's test windows; the device ops of one of
    its ClientUpdate steps are counted under torch.profiler), each lane's
    kernel once a round on its main
    route (``mnist_2nn_iid_superstep`` as one replay of its captured round,
    the wrappers counting the warm-up's launch before the capture, then a
    profiled chunk of 2 replays whose kernel records count their launches;
    ``fedavg_aggregate`` on the plain, FedSGD and FedAvgM lanes, the
    stream route of ``quantized_aggregate`` for q8, the fused route of
    ``sparse_aggregate`` for top-k, the gather route of ``gossip_mix`` for
    the ring and the small world, no kernel for low-rank); then 2 rounds
    against 1 + ``save`` + ``restore`` into a fresh engine + 1, bitwise for
    FedAvgM (params and velocity) and q8, within ``TOPK_RESUME_RTOL`` for
    top-k, the cohort of round 2 identical; and
    ``launch.train --checkpoint-dir`` on a reduced Gemma-2B in bf16, read
    back bitwise through ``repro_torch.checkpoint``;
22. the superstep lane at full paper size (``RoundEngine(...,
    device_sampling=True).run(n, rounds_per_step=20)``: one round captured
    as a CUDA graph, replayed once a round): the 2NN and CNN non-IID plain
    lanes, the 2NN q8 and top-k lanes and the ``mnist_2nn_iid_superstep``
    spec. Each lane first holds one captured round against one eager round
    from the same generator state (bitwise on the 2NN plain and q8 lanes,
    within ``CAPTURE_RTOL`` of the update on top-k; the CNN bitwise on an
    engine with ``cudnn.deterministic``, its default-mode gap printed beside
    two eager rounds' own) and prints
    the warm-up, capture and instantiation seconds, the graph count and the
    peak memory; then times host-sampled rounds against superstep chunks (of
    5 on the CNN) in turns (host, superstep) and adds a ragged chunk without
    a second graph. The 2NN plain lane also runs a warm chunk under
    ``transfer_guard``, shows that a sync inside the round raises there,
    and resumes from ``save``: 20 replays of ``round()`` in a fresh engine
    equal the saved engine's chunk of 20, bitwise. Each lane then profiles
    one chunk: device busy, idle share, device ops, and the replays'
    launches, which the wrappers do not see: the profiler's records must
    hold the lane's main-route kernel once a replay and no other hand
    kernel. On top-k, superstep(20) is held against 20 ``round()`` calls of
    a second engine (every round's loss, the final params, the generator
    state). The spec runs its chunk of 20, then a profiled chunk;
23. the paper's other models at full size, one round each, ``fedavg_aggregate``
    once a round: the CIFAR CNN (100 IID clients of 500 24x24x3 crops,
    C=0.1 E=5 B=50) through ``FederatedTrainer``, the word-LSTM
    (``make_word_corpus()``, windows of 10, 51 authors a round, E=1 B=8)
    through ``RoundEngine``; ``python -m repro_torch.examples.shakespeare_lstm``
    in a process of its own, which must exit 0; and each of the three models
    at full width on a reduced population, a round on the card against the
    same round on the CPU;
24. the buffered-async lane and the streamed pool at full size: (a) the
    degenerate schedule (``buffer_k == concurrency == m``, zero latency)
    against the sync lane on the 2NN, 1 round, params bitwise; (b)
    ``mnist_2nn_noniid_async`` against the 2NN's sync lane under the same
    straggler model, 1 apply and round (seconds, ``sim_s``), and one
    profiled ``run(1)`` of the async engine (idle share); (c) the 2NN (1
    round; prefetch 1 and 0) and the CNN (1 round, ``cudnn.deterministic``)
    with ``pool`` a ``StreamedClientPool`` against the device pool, and one
    q8 2NN round, params and losses bitwise; (d) 2NN rounds in turns
    (device, streamed), the bytes staged a round, and one
    profiled streamed round: whether its side stream's host-to-device copies
    ran beside a kernel; (e) ``pool="auto"`` under a
    ``REPRO_DEVICE_POOL_BUDGET`` below the 2NN pool's estimate selects the
    streamed pool; (f) the population gate of ``benchmarks/round_engine.py``
    on the host-sampled lane: 10^5 generated clients (416 MB on disk), 10
    rounds of m = 20, RSS growth under 256 MB;
25. cohort sharding (``RoundEngine(mesh=make_client_mesh())``): (a) the four
    aggregation kernels in partial-sum mode (``normalized=False``) on every
    route at the 2NN and CNN shapes, with raw counts, ghost rows and an
    all-zero vector (exactly 0), against their plain versions; (b) an NCCL
    world of one at full size, a round a lane in turns (unsharded,
    sharded): the 2NN and CNN plain lanes (the CNN under
    ``cudnn.deterministic``), the 2NN q8, q4, top-k and FedAvgM lanes, each
    against the unsharded engine from the same seed within the reference's
    tolerances, its kernel once a round (the sharded rounds' in partial-sum
    mode); a warm sharded round under ``transfer_guard``; (c) the 2NN
    superstep at R = 20 under the NCCL mesh against the unsharded one,
    chunks in turns, a guarded chunk, and a profiled chunk whose records hold
    ``fedavg_agg_kernel`` once a replay beside NCCL's; (e)
    ``mnist_2nn_noniid`` with ``execution.mesh_axes`` through ``from_spec``,
    one round; (d) three ranks spawned from here, each on ``cuda:0``, under
    gloo (m = 10: 12 slots, 2 ghosts), the 2NN plain and q8 lanes for 1
    round, every rank's params the same and equal to (b)'s unsharded runs;
    a rank that fails or outlives its deadline fails the phase;
26. supersteps off the star lanes: (a) the gossip superstep
    (``RoundEngine(topology=...).run(n, rounds_per_step=R)``, one gossip round
    captured as a CUDA graph through ``gossip_mix``) on the 2NN ring and small
    world, the 2NN on the full graph and the CNN ring, 100 nodes each: two
    engines run R rounds each in turns (eager against captured), bitwise
    equal after each pair (the CNN under
    ``cudnn.deterministic``), with seconds a round both ways, the consensus,
    the capture's seconds and the peak memory; on the 2NN ring a guarded
    chunk (no sync, no new graph) and 2 + ``save``/``restore`` + 2 == 4
    bitwise; on each 2NN lane a profiled chunk whose records hold the route's
    kernel once a replay (gather on the ring and small world, dense on the
    full graph); (b) the 2NN with ``_lowrank``'s codec and
    ``device_sampling=True``: the sketch regrown on the card from the CPU's
    seeds, superstep(20) against 20 ``round()`` calls, host-sampled rounds
    against chunks in turns, one payload's realized bytes; (c) the streamed
    pool's staged superstep against the device pool's, the 2NN and CNN plain
    and the 2NN q8 lanes, chunks in turns, bitwise, the streamed / device
    ratio, the bytes staged a chunk, a profiled streamed chunk (do the next
    chunk's staging copies run beside the replays?), and the 10^5-client
    population in one chunk (RSS growth under 256 MB); (d) ``from_spec`` on
    the ring and small-world specs with ``rounds_per_step``, the low-rank spec
    with ``device_sampling=True`` and a streamed superstep spec, one chunk
    each;
27. training Jamba: ``jamba-v0.1-52b`` at full width (d_model 4096, 16
    experts top-2, d_state 16) cut to its first 2 layers (Mamba/MLP,
    Mamba/MoE; 3.74 B params) through ``repro_torch.launch.train.run`` with
    ``--full --n-layers 2 --state-dtype bfloat16``: 2 FedAvg rounds of G = 2
    groups x H = 2 AdamW steps on 2 x 2048 tokens a group, bf16, remat, each
    round launching ``ssm_scan`` 16 times (2 Mamba layers, forward and remat
    recompute, 4 steps), ``ssm_scan_bwd`` 8, ``fused_cross_entropy`` 4 and
    ``ce_probs`` 16 on the tensor-core route, ``fedavg_aggregate`` once a
    parameter leaf (34) and ``flash_attention`` never; finite losses, the
    peak under 75 GiB; seconds, tokens/s and peak a round; then one
    profiled group step (idle share, top kernels, the shares of the scan's
    two kernels, the CE and AdamW) and each Mamba mixer and the MoE FFN
    timed alone;
28. serving MLA and the vision stub at phases 14-15's traffic, each model
    drawn on the card from seed 0 and freed before the next:
    DeepSeek-V2-Lite whole (27 layers), DeepSeek-V3 at full width cut to
    its first 4 layers (3 dense, 1 MoE), Qwen2-VL-7B whole on stub
    embeddings with 3-D M-RoPE positions whose components differ;
    ``flash_attention`` once a layer a request, every launch on the
    tensor-core route (MLA's at D = 192); prefill + decode equals forward
    at full width (Qwen2-VL in bf16; MLA at B = 1, one layer in bf16 and
    the whole model in fp32, its bf16 gap printed: MoE routing flips under
    bf16 rounding); one profiled prefill and decode step of each. Phase 16
    holds the three reduced configs card vs CPU;
29. serving the last two archs at the same traffic, each drawn on the card
    from seed 0 and freed before the next: xLSTM-350M whole (24 blocks, 21
    mLSTM and 3 sLSTM; plain torch, as the reference's plain XLA, so no
    flash launch) and SeamlessM4T-medium whole (12 encoder + 12 decoder
    layers over 4,096 frames of stub encoder embeddings): ``flash_attention``
    36 times a request (each encoder layer, decoder self-attention and
    cross-attention once, non-causal but for the decoder's self-attention,
    cross-attention at Sq = 2048 over Sk = 4096), all on the tensor-core
    route, none in a decode step; prefill + decode equals forward
    (SeamlessM4T at full width in bf16; xLSTM's whole model at full width in
    bf16 and in fp32 and at the reduced width in bf16, one mLSTM and one
    sLSTM block at full width in bf16); xLSTM's rows against the row count
    (a forward over S - 1 tokens against the first S - 1 positions over S,
    one block of each kind and the whole model, and its bf16 products over
    S - 1 and 2 rows), printed; one profiled prefill and decode step of
    each, and for xLSTM the device time and ops of its mLSTM chunkwise and
    sLSTM ranges in a prefill. Phase 16 holds both reduced configs card vs
    CPU; phases 3 and 4 hold and time the flash kernel non-causal at Sq !=
    Sk;
30. training the last two archs whole at full width through
    ``repro_torch.launch.train.run --full --remat``: xLSTM-350M (24 blocks)
    and SeamlessM4T-medium (12 + 12 layers over 2048 frames of stub
    embeddings), bf16, one FedAvg round of G = 2 groups x H = 2 AdamW steps
    (fp32 moments) on 2 x 2048 tokens a group, each drawn on the card from
    seed 0 and freed before the next: ``flash_attention`` 288 times a
    SeamlessM4T round (36 flash layers, forward and remat recompute, 4
    steps) and never in xLSTM's, ``fused_cross_entropy`` 4 and ``ce_probs``
    16 a round, all on the tensor-core routes (SeamlessM4T's 256,206-word
    head staged to a pitch of 256,208), ``fedavg_aggregate`` once a
    parameter leaf; finite losses, the peak under 75 GiB; seconds, tokens/s
    and peak a round; then one profiled group step of each (idle share,
    device ops, the shares of AdamW, the CE and the attention backward, and
    xLSTM's sLSTM and mLSTM ranges) and xLSTM's sLSTM layer timed alone.

Phases 3 and 4 hold and time ``flash_attention``, ``ssm_scan``,
``fused_cross_entropy``, ``ce_probs`` and ``ssm_scan_bwd`` too, at the
serving and training shapes (phase 30's among them: the CE at V = 50,304
and at V = 256,206 through the staged head, the staging copy timed beside
it; ``FlashAttention`` at SeamlessM4T's three training shapes, its forward
with ``lse`` and its backward against the plain versions); phase 3 also
holds the flash kernel's ``lse`` output and the scan's checkpoints, and
checks that every kernel wrapper refuses an input that requires grad.
``flash_attention`` and ``fused_cross_entropy`` have two routes each, a
tensor-core kernel (bf16 on aligned rows; flash at D = 64, 128, 192, 256) and a
scalar one (everything else): phase 3 checks which route each case took
(``tc_launches`` beside ``launches``) and runs every bf16 CE case on both;
phase 4 times both routes in turns at the main shapes and requires the
tensor-core route to be at least 5x faster, and times the CE backward
against the plain one it replaced; phases 14-15, 18 and 20 require every
flash and CE launch of the serving and training paths to take the
tensor-core route, as phase 28 does MLA's and Qwen2-VL's. ``gossip_mix`` has two routes too, the gather kernel
(sparse plans) and the dense kernel (the full graph; ``dense_launches``
beside ``launches``): phase 3 runs every case on the route ``_route`` picks
and the 100-node ring, small world and full graph through each route
forced, phase 4 times both routes in turns on those plans. ``ssm_scan``
splits each channel's states across 1, 2 or 4 lanes (``lane_launches``):
phase 3 runs every case with each, phase 4 times each in turns and
requires the launch plan's to be within 5% of the fastest.
``quantized_aggregate`` and ``packed_quantized_aggregate`` have two routes,
the stream kernel (the specs' shapes: chunk 512 at q8, q16 and bits 1/2/4;
``stream_launches`` beside ``launches``) and the general kernels (the
rest): phase 3 runs every case on the route ``_route`` picks and every case
the stream route takes through both routes forced, phase 4 times both
routes in turns at the main shapes and requires the stream route to be no
slower at the CNN shape, and phases 8-10 require every q8 and q4 launch of
a compressed round on the stream route. ``sparse_aggregate`` has two
routes, the fused kernel (one cooperative launch that zeroes the output and
scatters; k % 4 == 0 on aligned rows, the specs' top-5%;
``fused_launches`` beside ``launches``) and a fill then the scatter kernel
(the rest): phase 3 runs every case on the route ``_route`` picks and every
case the fused route takes through both routes forced, phase 4 times both
routes in turns at the main shapes and requires the fused route to be no
slower at the CNN shape, and phase 8 requires every top-k launch of a
compressed round on the fused route. ``ce_probs``
(the CE gradient's kernel) and ``ssm_scan_bwd`` (the scan's backward, from
the checkpoints its forward writes) port no Pallas kernel; they are held,
timed and counted like the eight that do. Every
kernel's launch count is set to 0 just before each lane's run and read just
after; a wrapper counts the launches it makes, and a CUDA graph's replays
(phases 21, 22, 25 and 26) are counted from the profiler's kernel records
instead. Each
phase prints its seconds.
The last three lines are the card's ``nvidia-smi`` name and power limit, a
``{"kernels": [...]}`` record and ``{"ok": true, "device": {...}}``. Any failure exits non-zero
before those lines; so does a machine without a card.
"""
from __future__ import annotations

import dataclasses
import gc
import itertools
import json
import math
import re
import subprocess
import sys
import time
from pathlib import Path
from typing import NamedTuple

import numpy as np
import torch

ROOT = Path(__file__).resolve().parent
sys.path.insert(0, str(ROOT / "src"))

# NVIDIA H100 SXM data sheet: HBM3 rate and fp32 (non-tensor-core) peak.
# An SM issues half as many int32 as fp32 operations a clock.
HBM_BYTES_PER_S = 3.35e12
FP32_FLOPS = 67e12
INT32_OPS = FP32_FLOPS / 2
BF16_FLOPS = 989e12                     # dense, tensor cores
# Special-function units (exp2): 16 a clock per SM, 132 SMs, 1.98 GHz boost.
SFU_OPS = 16 * 132 * 1.98e9
# The L2 flush before each timed launch reads a 256 MB buffer (well above
# the 50 MB L2) that was written once: the L2 is left holding clean lines. A
# flush that writes the buffer leaves 50 MB of dirty lines, and a kernel
# that evicts them pays their write-back: at the q8 CNN bytes it cost the
# streaming floor 1.20x the clean flush's time on an H100
# (kernels/probe.py).
L2_FLUSH_BYTES = 256 * 2**20
MAIN_K = 10                             # m = C * K = 0.1 * 100 clients
MAIN_N = {"mnist_2nn": 199_210, "mnist_cnn": 1_663_370}
# fedavg_aggregate at the paper's other models' rounds (K = the cohort):
# the Shakespeare spec's char-LSTM (115 of 1146 roles; hidden 128, V 72),
# the CIFAR CNN (10 of 100) and the word-LSTM (51 of 512 authors).
PAPER_AGG_SHAPES = {"char_lstm": (115, 211_592), "cifar_cnn": (10, 1_068_298),
                    "word_lstm": (51, 4_359_120)}
# ... and at the buffered-async apply of the async specs: K = buffer_k = 3
# buffered 2NN updates (phases 21 and 24).
ASYNC_AGG_SHAPES = {"async_apply": (3, 199_210)}
AGG_SHAPES = {**PAPER_AGG_SHAPES, **ASYNC_AGG_SHAPES}
ROUNDS = {"mnist_2nn": 3, "mnist_cnn": 2}
CHECK_STEPS = 3                         # the longer card-vs-CPU round: E=1, 3 steps
# Card vs CPU round, both in fp32, compared on the round's update in L2
# relative to its size. One step differs only by sums taken in other orders
# (and a near-tie in a ReLU or max-pool window routing one unit's gradient
# elsewhere). Later steps start from params that already differ, and SGD at
# the CNN's initial loss (~15) amplifies that step by step: 3 steps measured
# 7.4e-4 on an H100, so that check only rules out layout and indexing errors.
UPDATE_RTOL_1 = 1e-4
UPDATE_RTOL_N = 1e-2
LOSS_RTOL = 1e-4
# The gossip lane's 1-step CNN round on 100 nodes measured 1.7e-4 card vs
# CPU on an H100 (the 2NN stays within UPDATE_RTOL_1). Each 1-step gossip
# round is therefore also run on the CPU in fp64, and both fp32 rounds are
# held to it: there the CPU's own fp32 round measured 8.1e-5 from fp64 and
# the card's 1.5e-4, so fp32 rounding alone moves this round by ~1e-4.
GOSSIP_CNN_RTOL_1 = 1e-3
# The same fp64 round on the card against the CPU's: the same function,
# parted only by sums in other orders and by the loss's softmax, which the
# port's cross-entropy takes in fp32 (~6e-8 relative) in fp64 rounds too.
FP64_RTOL = 1e-6

# The eight ported TPU kernels, then the two training kernels that port no
# Pallas kernel (the reference's gradients there are XLA's autodiff):
# ce_probs, the CE gradient's, and ssm_scan_bwd, the Mamba scan's backward.
KERNELS = ("fedavg_aggregate", "quantized_aggregate", "packed_quantized_aggregate",
           "sparse_aggregate", "gossip_mix", "flash_attention", "ssm_scan",
           "fused_cross_entropy", "ce_probs", "ssm_scan_bwd")
WIRE_KERNELS = KERNELS[1:4]             # the compressed lane's
PARTIAL_KERNELS = KERNELS[:4]           # the four with a partial-sum mode (phase 25)
CHUNK = 512                             # the specs' quantize chunk
TOPK = 0.05                             # specs/mnist_2nn_noniid_topk.json
# One round a lane: the script is kept near 500 s, and phase 22 runs 40 rounds
# of each of its lanes.
COMPRESSED_ROUNDS = 1
# (model, spec whose codec the lane uses, codec override, kernel of the aggregate)
LANES = (
    ("mnist_2nn", "mnist_2nn_noniid_q8", {}, "quantized_aggregate"),
    ("mnist_2nn", "mnist_2nn_noniid_q8", {"bits": 4}, "packed_quantized_aggregate"),
    ("mnist_2nn", "mnist_2nn_noniid_topk", {}, "sparse_aggregate"),
    ("mnist_2nn", "mnist_2nn_noniid_lowrank", {}, None),     # an einsum, no hand kernel
    ("mnist_cnn", "mnist_2nn_noniid_q8", {}, "quantized_aggregate"),
    ("mnist_cnn", "mnist_2nn_noniid_topk", {}, "sparse_aggregate"),
)
# One client's upload bytes by codec at each model's size (the reference's
# ``codec.wire_bytes``); realized payload bytes must equal them.
WIRE_BYTES = {
    199_210: {"q8": 202_330, "q4": 102_728, "top0.05": 79_680, "lowrank8": 14_280},
    1_663_370: {"q8": 1_689_362, "top0.05": 665_344},
}
# The low-rank aggregate is an einsum of 80-term fp32 sums on both sides:
# held in L2 relative to its size.
LOWRANK_RTOL = 1e-5

N_NODES = 100                           # the gossip specs: every client is a node
GOSSIP_ROUNDS = 1                       # one round a lane, as COMPRESSED_ROUNDS
# (model, spec whose topology, fedavg and partition sections the lane uses);
# no CNN gossip spec exists, so the CNN takes the 2NN ring spec's sections.
GOSSIP_LANES = (
    ("mnist_2nn", "mnist_2nn_noniid_ring"),
    ("mnist_2nn", "mnist_2nn_noniid_smallworld"),
    ("mnist_cnn", "mnist_2nn_noniid_ring"),
)
# The CNN ring takes the ring spec's sections at this learning rate, not the
# spec's 0.1 (the 2NN's): at 0.1 some of the 100 CNN nodes train to NaN in
# the first round on the engine's device stream, under cudnn.deterministic
# or not, and the mix spreads it; at 0.05 the rounds stay finite
# (scripts/probe_cnn_ring.py; its numbers are in PERF.md).
GOSSIP_CNN_LR = 0.05
# The anchor. The node mean and FedAvg's params differ only in the order of
# an fp32 sum of 100 terms: the reference's own tolerance
# (tests/test_engine_gossip.py). The full graph's replicas differ only by
# fp32 rounding, so the consensus distance is held to 1e-6 of the replicas'
# RMS norm (a ring's is a few percent of it). The losses are the same
# per-client losses, weighted alike.
ANCHOR_ATOL = 2e-5
ANCHOR_CONSENSUS_RTOL = 1e-6
ANCHOR_LOSS_RTOL = 1e-6

# Serving the LM substrate: B = 4 prompts of 2048 tokens, greedy decode to 32
# tokens (31 decode steps), as repro_torch.launch.serve does it. Jamba at its
# full width and one period of 8 layers (the full 32 do not fit one card in
# bf16), Gemma-2B whole.
SERVE_BATCH, PROMPT, SERVE_TOKENS = 4, 2048, 32
JAMBA_LAYERS = 8
# flash_attention's prefill shapes (B, S, H, K, D) and Jamba's scan
# (d_inner 8192, d_state 16). MLA's prefill (DeepSeek) attends at D = 192
# (qk_nope 128 + qk_rope 64, V zero-padded from 128), every head its own K:
# H = K = 16 on V2-Lite, 128 on V3.
FLASH_SHAPES = {"jamba": (SERVE_BATCH, PROMPT, 32, 8, 128),
                "gemma-2b": (SERVE_BATCH, PROMPT, 8, 1, 256),
                "gemma-2b train": (2, 2048, 8, 1, 256),
                "deepseek-v2-lite": (SERVE_BATCH, PROMPT, 16, 16, 192),
                "deepseek-v3": (SERVE_BATCH, PROMPT, 128, 128, 192),
                "seamless decoder": (SERVE_BATCH, PROMPT, 16, 16, 64)}
# SeamlessM4T's decoder self-attention is causal MHA at head dim 64 (above);
# its prefill also attends non-causally at head dim 64 (1024 / 16): its
# encoder's 12 layers over SEAMLESS_FRAMES frames (Sq = Sk), its decoder's 12
# cross-attention layers from the prompt's 2048 tokens over them (Sq != Sk):
# (B, Sq, Sk, H, K, D).
SEAMLESS_FRAMES = 4096
FLASH_NONCAUSAL_SHAPES = {
    "seamless encoder": (SERVE_BATCH, SEAMLESS_FRAMES, SEAMLESS_FRAMES, 16, 16, 64),
    "seamless cross": (SERVE_BATCH, PROMPT, SEAMLESS_FRAMES, 16, 16, 64)}
# The scalar route's launches a timing turn: FLASH_SCALAR_ITERS where a shape
# sets it (V3's 825 GFLOP at ~14 TFLOP/s: ~59 ms a launch), else
# FLASH_SCALAR_DEFAULT_ITERS (its launches take 2.7-8.1 ms); the tensor-core
# route's median of 200.
FLASH_SCALAR_DEFAULT_ITERS = 20
FLASH_SCALAR_ITERS = {"deepseek-v2-lite": 50, "deepseek-v3": 10, "seamless decoder": 50,
                      "seamless encoder": 10, "seamless cross": 20}
FLASH_WINDOW = 100
# Phase 30's attention: SeamlessM4T trains on B = 2 sequences of 2048 tokens
# over min(2048, 4096) = 2048 frames, so its encoder and its cross-attention
# attend non-causally at Sq = Sk = 2048 and its decoder causally; H = K = 16,
# D = 64, bf16, the forward with lse (ops.FlashAttention), then the plain
# backward: (B, Sq, Sk, H, K, D, causal).
# Phase 31's: DeepSeek-V2-Lite's MLA at the qk head dim 192 (V zero-padded
# from 128), H = K = 16, and Qwen2-VL's GQA 28/4 at D = 128, both causal.
FLASH_TRAIN_SHAPES = {"seamless train encoder": (2, 2048, 2048, 16, 16, 64, False),
                      "seamless train cross": (2, 2048, 2048, 16, 16, 64, False),
                      "seamless train decoder": (2, 2048, 2048, 16, 16, 64, True),
                      "deepseek-v2-lite train": (2, 2048, 2048, 16, 16, 192, True),
                      "qwen2-vl train": (2, 2048, 2048, 28, 4, 128, True)}
SSM_D, SSM_N = 8192, 16
# The prefill+decode == forward invariant at full width in bf16, at a size
# where Jamba's MoE buffers at capacity factor 8 fit. A bf16 value holds 8
# significant bits (2^-8 = 0.4%), and the two paths round at other places
# through every layer's residual stream: the logits are held to 2^-5 (3.1%)
# of their largest magnitude.
INVARIANT_SHAPE = (2, 128)
INVARIANT_RTOL = 2.0 ** -5
# Phase 29. SeamlessM4T's bf16 gap at the reduced width (0-0.54% over four
# seeds, the reference on the CPU) sits under INVARIANT_RTOL; its memory is
# INVARIANT_FRAMES frames. xLSTM's whole bf16 model is held at full width,
# and at the reduced width and full depth, to XLSTM_INVARIANT_RTOL (2^-4): at
# least twice the reference's own gap at either width (full width, seeds 0
# and 1: 2.65% and 2.27% on the CPU, the port 2.44% and 1.92% on the same
# params; tests/test_torch_xlstm.py). Its bf16 products take fp32 sums and
# one rounding (models/xlstm.py ``_mm``) and its chunkwise form one chunk
# size whatever S: before, a bf16 GEMM's blocking by the row count gave the
# prefill over S - 1 tokens other bits than the forward over S, and the gap
# grew block by block to 6.4-10.7% at full width on an H100
# (scripts/probe_xlstm_invariant.py). The mLSTM's fp32 gate products take
# fp64 sums (``_mm_gate``): cuBLAS's fp32 kernel for them took other bits
# by the row count too. One mLSTM and one sLSTM block are held at full width
# in bf16 at XLSTM_BLOCK_RTOL (2^-7) on the inputs of XLSTM_BLOCK_SEEDS: at
# least twice the reference's own one-block gap there (mLSTM 0.02-0.29%;
# the sLSTM's is 0); on an H100 the mLSTM block reads 0-0.54% over 12
# weight and input seeds, the sLSTM block 0.
# The whole model is held in fp32 (fresh fp32 weights) at
# XLSTM_FP32_INVARIANT_RTOL (ten times the reference's fp32 gap at the
# reduced width and full depth, 3.0-6.9e-6). tests/test_torch_xlstm.py and
# tests/test_torch_encdec.py hold each tolerance against the reference's
# gaps.
XLSTM_INVARIANT_RTOL = 2.0 ** -4
XLSTM_BLOCK_RTOL = 2.0 ** -7
XLSTM_BLOCK_SEEDS = (1, 2, 3)
XLSTM_FP32_INVARIANT_RTOL = 1e-4
# xLSTM-350M's serving readings on an H100 80GB HBM3 at 700 W before its
# products took fp32 sums (PERF.md section 5), printed beside phase 29's
XLSTM_SERVING_BEFORE = {"prefill_s": (1.9521, 3.2504), "decode_ms_per_token": (27.2, 40.4)}
INVARIANT_FRAMES = 128
# MLA's prefill (the naive up-projection in bf16, through the flash kernel)
# and its decode (the absorbed form in fp32) round at other places. One MLA
# layer at full width in bf16, the last token of prefill + decode against
# the same layer over the whole sequence, is held to MLA_LAYER_RTOL of its
# largest output: the reference's own gap there, on the CPU at the reduced
# width, is 0.29-0.57% (tests/test_torch_mla_invariant.py holds twice it
# under this). The whole MoE model in bf16 is not held: at full width a
# decoded token's top-k experts flip between the two paths under bf16
# rounding (V2-Lite: 3 to 17 of its 26 MoE layers flipped at the last
# token over four prompts, the gap 5.6-17.8% of the largest logit, on an
# H100; scripts/probe_moe_invariant.py), and an expert's output at d_model
# 2048-7168 is as large as the residual stream, so the gap is whatever the
# flips make it; it is measured and printed. The whole model is held in
# fp32 instead (fresh fp32 weights, where the paths part by ~1e-6 and no
# router margin is that thin), to MLA_FP32_INVARIANT_RTOL: ten times the
# reference's own fp32 gap at the reduced width and the served depth
# (0.9-5.1e-6, the same test). All at B = 1.
MLA_LAYER_RTOL = 2.0 ** -6
MLA_FP32_INVARIANT_RTOL = 1e-4
MLA_INVARIANT_SHAPE = (1, 128)
# Phase 28, serving MLA and the vision stub at the same traffic as phases
# 14-15: (arch, layers; 0 = all). V3 at full width is cut to its 3 dense
# layers and its first MoE layer (15.1 B params, 30 GB in bf16; all 61 take
# 1.3 TB).
MLA_VISION_SERVING = (("deepseek-v2-lite-16b", 0), ("deepseek-v3-671b", 4), ("qwen2-vl-7b", 0))
# Phase 29, the last two archs whole at the same traffic: (arch, flash launches
# a request). xLSTM's blocks are plain torch (the reference's are plain XLA);
# SeamlessM4T's 12 encoder layers, 12 decoder self-attentions and 12
# cross-attentions each launch flash once a prefill.
XLSTM_SEAMLESS_SERVING = (("xlstm-350m", 0), ("seamless-m4t-medium", 36))
# The reduced configs in fp32, card vs CPU: the reference's own prefill+decode
# consistency bound on logits, and 1e-4 on the caches (sums in other orders).
REDUCED_LOGITS_ATOL = 3e-4
REDUCED_CACHE_ATOL = 1e-4

# Training the LM substrate: Gemma-2B whole (18 layers, bf16, remat, ce_chunk
# 512), FedAvg rounds of G = 2 client groups x H = 2 local AdamW steps on
# B = 2 sequences of 2048 tokens a group, through repro_torch.launch.train.
TRAIN_ARGV = ["--arch", "gemma-2b", "--full", "--groups", "2", "--local-steps", "2",
              "--global-batch", "4", "--seq", "2048", "--rounds", "2", "--device", "cuda"]
TRAIN_G, TRAIN_H, TRAIN_B, TRAIN_S = 2, 2, 2, 2048
PEAK_LIMIT_GIB = 75.0
# fused_cross_entropy at the training step's shape: T = B * S tokens of the
# tied 256,000-word head, d = 2048, bf16; the backward takes B * ce_chunk
# (Gemma-2B's 512) tokens at a time, so ce_probs launches CE_CHUNKS times a
# step
CE_SHAPE = (TRAIN_B * TRAIN_S, 2048, 256_000)
CE_CHUNK_TOKENS = TRAIN_B * 512
CE_CHUNKS = -(-CE_SHAPE[0] // CE_CHUNK_TOKENS)
CE_MIN_SPEEDUP = 5.0   # the tensor-core route against the scalar one, same run
# Phase 30's CE at its training step (T = 2 x 2048 tokens, d_model 1024), each
# head in the layout train_loss passes it: xLSTM's untied (1024, 50,304) head
# contiguous (V % 8 = 0); SeamlessM4T's untied (1024, 256,206) head, whose
# pitch is no multiple of 8, staged by ops.FusedCrossEntropy into a (1024,
# 256,208) buffer and passed on as its (1024, 256,206) view
# Phase 31's: DeepSeek-V2-Lite's untied (2048, 102,400) head and Qwen2-VL's
# (3584, 152,064), both contiguous (V % 8 = 0).
CE_ARCH_SHAPES = {"xlstm-350m": (TRAIN_B * TRAIN_S, 1024, 50_304, "contiguous"),
                  "seamless-m4t-medium": (TRAIN_B * TRAIN_S, 1024, 256_206, "staged"),
                  "deepseek-v2-lite-16b": (TRAIN_B * TRAIN_S, 2048, 102_400, "contiguous"),
                  "qwen2-vl-7b": (TRAIN_B * TRAIN_S, 3584, 152_064, "contiguous")}
# The card's fp32 round against the CPU's: sums in other orders through two
# layers and back, in the SGD update and in AdamW's moments.
TRAIN_RTOL = 1e-4
# FlashAttention's dq, dk, dv from the kernel's forward against the same plain
# backward from the plain forward (phase 3): the two forwards' outputs part by
# at most a bf16 ulp and their lse by 1e-5, and each gradient is rounded to
# bf16 once; held as CE_GRAD_RTOL holds the CE's (rel L2).
FLASH_GRAD_RTOL = 1e-3
# Phase 30: xLSTM-350M and SeamlessM4T-medium whole at full width, bf16,
# remat, through launch.train.run: one FedAvg round of TRAIN_G x TRAIN_H
# AdamW steps (fp32 moments: both fit) on TRAIN_B x TRAIN_S tokens a group,
# SeamlessM4T's over min(TRAIN_S, 4096) frames, then one profiled group step.
ARCH_TRAIN = ("xlstm-350m", "seamless-m4t-medium")
ARCH_TRAIN_LR = 3e-4
# Phase 31: DeepSeek-V2-Lite at full width cut to its dense layer and 3 MoE
# layers (2.2 B params) and Qwen2-VL-7B at full width cut to 8 layers (2.95
# B) through launch.train.run --full --n-layers L, the same round as phase
# 30's with bf16 moments: neither fits one card whole with two replicas and
# their moments (29.3 and 14.2 GiB a replica in bf16).
MLA_VISION_TRAIN = (("deepseek-v2-lite-16b", 4), ("qwen2-vl-7b", 8))
# Phase 30's archs that take no profiled group step: xLSTM's is host-bound
# (~490,000 device ops; on an H100 the profiled step and its trace read took
# ~45 s of the script, ~68 s with the model built for it; PERF.md section 5
# keeps its breakdown); its sLSTM layer alone is still timed against the
# lane's step.
UNPROFILED_TRAIN = ("xlstm-350m",)
MLA_VISION_TRAIN_LAUNCHES = {
    "deepseek-v2-lite-16b": {"flash_attention": 32, "fused_cross_entropy": 4, "ce_probs": 16},
    "qwen2-vl-7b": {"flash_attention": 64, "fused_cross_entropy": 4, "ce_probs": 16}}
# Leaves whose gradient is 0 in exact arithmetic: the mLSTM's input-gate bias
# (its output is invariant to one shift of every input gate; the stabilizer
# takes it up), whose gradient is fp32 rounding on either device (about 1e-9
# on the CPU, tests/test_torch_xlstm.py). Held by norm, not against each
# other. Phase 19's SeamlessM4T round takes REDUCED_TRAIN_FRAMES frames.
ZERO_GRAD_LEAVES = ("bi",)
ZERO_GRAD_ATOL = 1e-6
REDUCED_TRAIN_FRAMES = 24
# Phase 19's leaves held one by one within TRAIN_RTOL beside the whole tree:
# every leaf's gradient of one step; in the SGD update, attention's and the
# tied head; in AdamW's moments, those and Mamba's and the MoE router. Not
# Mamba's SGD update: an update is the difference of two fp32 params, and
# where it is a few ulps of the values (dt_bias: gradients near 1e-5
# against values near -4, a median step of 0 ulps) it is the params'
# rounding that is compared (on an H100, 0.79 relative on one layer's
# dt_bias, the whole tree's update at 1.6e-5, that leaf's gradient 4.2e-6).
# The same rounding sets the SGD lr: at 0.05 reduced Jamba's attention
# weights step ~3,000 ulps and their updates part by 1.2e-4 on an H100
# (their gradients 4e-6 or less); at 0.5, ~32,000 ulps and 1.6e-5.
REDUCED_SGD_LR = 0.5
# AdamW's lr in phase 19's rounds, by arch (None: the rest). The round's
# second local step reads the first step's update, lr * g / (|g| + eps), in
# which card-vs-CPU rounding of near-zero gradient elements moves a
# parameter by up to about lr / 2 (the mLSTM's mk and mq). xLSTM's second
# step carries that into its moments in proportion to lr: on an H100 80GB
# HBM3 at 700 W, card vs CPU 1.2e-4 at lr 1e-3, 1.2e-5 at 1e-4, 2.2e-6
# after one step; Gemma-2B 2.0e-5 at 1e-3.
REDUCED_ADAMW_LR = {None: 1e-3, "xlstm-350m": 1e-4}
UPDATE_LEAVES = ("wq", "wk", "wv", "wo", "table", "wq_a", "wq_b", "wkv_a", "wkv_b", "bq", "bk",
                 "bv")
MOMENT_LEAVES = UPDATE_LEAVES + ("in_proj", "conv_w", "x_proj", "dt_proj", "dt_bias", "A_log",
                                 "D", "out_proj", "router")
# Phase 27, Jamba trained at full width (d_model 4096, 16 experts top-2,
# d_state 16), cut to its first 2 layers (Mamba/MLP, Mamba/MoE; 3.74 B
# params) with bf16 AdamW moments, so that two group replicas, their
# moments and one group's gradients fit the card; otherwise phase 18's
# round: bf16, remat, G = 2 x H = 2 AdamW steps on 2 x 2048 tokens a group,
# at lr 3e-4 (at launch.train's 3e-3 the loss rose from 12.1 to 16.5 in 2
# rounds on an H100).
JAMBA_TRAIN_LR = 3e-4
JAMBA_TRAIN_LAYERS = 2
JAMBA_TRAIN_ARGV = ["--arch", "jamba-v0.1-52b", "--full", "--n-layers", str(JAMBA_TRAIN_LAYERS),
                    "--state-dtype", "bfloat16", "--groups", "2", "--local-steps", "2",
                    "--global-batch", "4", "--seq", "2048", "--rounds", "2", "--lr",
                    str(JAMBA_TRAIN_LR), "--device", "cuda"]
# ssm_scan_bwd on the card against its plain version: each gradient within
# 1e-5 of its largest magnitude (at least 1), as the forward is held: fp32
# sums over states, channels and time in other orders, and ex2.approx for
# exp, which the state's decay carries through the recurrence.
SSM_BWD_RTOL = 1e-5
SSM_TRAIN_B = 2           # phase 27's scan: B = 2 sequences of 2048 tokens a group
# The kernel's CE against fp32 logits materialized from the same bf16 hidden:
# two fp32 sums of 2048 products and of 256,000 exponentials in other orders.
CE_MATERIALIZED_RTOL = 1e-5
# FusedCrossEntropy's bf16 gradients against autograd through materialized
# fp32 logits, rounded to bf16 alike.
CE_GRAD_RTOL = 1e-3

# Phase 21, the spec front door: each runnable spec of specs/*.json at full
# size through RoundEngine.from_spec, with the kernel its lane must launch
# once a round (None: low-rank aggregates by an einsum, no hand kernel).
SPEC_ROUNDS = 1                         # one round a spec, as COMPRESSED_ROUNDS
# Two rounds where the second starts from state the first left: FedAvgM's
# velocity, the gossip replicas after a mix. (The codec stream's second draw
# is run by the q8 and top-k resumes.)
SPEC_ROUNDS_OF = {"mnist_2nn_noniid_fedavgm": 2, "mnist_2nn_noniid_ring": 2,
                  "mnist_2nn_noniid_smallworld": 2}
# The buffered-async specs run this many applies (each one fedavg_aggregate
# launch over K = buffer_k = 3 buffered updates), and their sim_s sequence
# must equal, float for float, the same spec's on the CPU: the event
# schedule is host numpy only. Three applies keep the script inside its time
# limit.
ASYNC_SPECS = ("mnist_2nn_noniid_async", "mnist_2nn_noniid_fedasync")
ASYNC_APPLIES = 3
SPEC_ROUNDS_OF.update({name: ASYNC_APPLIES for name in ASYNC_SPECS})
SPEC_KERNELS = {
    "mnist_2nn_iid": "fedavg_aggregate", "mnist_2nn_noniid": "fedavg_aggregate",
    "mnist_cnn_iid": "fedavg_aggregate", "mnist_cnn_noniid": "fedavg_aggregate",
    "mnist_2nn_fedsgd": "fedavg_aggregate", "mnist_2nn_noniid_fedavgm": "fedavg_aggregate",
    "mnist_2nn_noniid_q8": "quantized_aggregate", "mnist_2nn_noniid_topk": "sparse_aggregate",
    "mnist_2nn_noniid_lowrank": None,
    "mnist_2nn_noniid_ring": "gossip_mix", "mnist_2nn_noniid_smallworld": "gossip_mix",
    "mnist_2nn_iid_superstep": "fedavg_aggregate", "shakespeare_lstm": "fedavg_aggregate",
    "mnist_2nn_noniid_async": "fedavg_aggregate", "mnist_2nn_noniid_fedasync": "fedavg_aggregate",
}
# The Shakespeare spec's clients: one a role of make_char_corpus at its
# defaults (the spec's 1146 roles, 3,110 mean characters), cut into windows
# at the paper's unroll of 80; its test windows are every role's test text.
CHAR_UNROLL = 80
# Resume on the card: 2 rounds against 1 + save + restore + 1. FedAvgM's and
# q8's rounds run no atomics (fedavg_agg.cu and quantized_agg.cu hold none),
# cuBLAS and cuDNN pick the same algorithms for the same shapes in one
# process, and every random draw is seeded from the restored host stream, so
# those must be bitwise equal. sparse_agg.cu scatters with fp32 REDs, whose
# order changes a colliding index's sum by an ulp or so (half the top-5%
# indices of a round collide); a round of SGD from such a start stays far
# inside 1e-3 of the 2 rounds' update in L2.
TOPK_RESUME_RTOL = 1e-3
RESUME_ROUNDS = 2
RESUME_SPECS = (("mnist_2nn_noniid_fedavgm", None), ("mnist_2nn_noniid_q8", None),
                ("mnist_2nn_noniid_topk", TOPK_RESUME_RTOL))
# Phase 22, the superstep lane: each lane at full paper size as one captured
# round replayed once a round, R = 20 rounds a chunk (the superstep spec's).
# Lanes: (model, spec whose codec the lane takes or None, kernel).
SUPERSTEP_R = 20
SUPERSTEP_LANES = (
    ("mnist_2nn", None, "fedavg_aggregate"),
    ("mnist_cnn", None, "fedavg_aggregate"),
    ("mnist_2nn", "mnist_2nn_noniid_q8", "quantized_aggregate"),
    ("mnist_2nn", "mnist_2nn_noniid_topk", "sparse_aggregate"),
)
# Host-sampled rounds a turn, beside each superstep chunk, in the turns
# SUPERSTEP_TURNS (one pair, to keep the script inside its time).
SUPERSTEP_HOST_ROUNDS = {"mnist_2nn": 1, "mnist_cnn": 1}
SUPERSTEP_TURNS = ("host", "superstep")
# The timed chunk where it is not SUPERSTEP_R: a CNN superstep round holds
# the card ~0.39 s, so its chunk is cut to 5 (seconds a round are the
# replays' whatever the chunk; the 2NN's 20 rounds take ~0.9 s).
SUPERSTEP_TURN_R = {"mnist_cnn": 5}
# The profiled chunk of each lane (CUPTI records every replayed kernel: a 2NN
# round runs ~17,000 device ops, a CNN round ~53,000). A replay runs on the
# card without the kernel wrappers, so their counters count only eager
# launches (the warm-up's); the replays' launches are the profiler's records
# of the lane's main-route kernel, by name, r in a chunk of r.
SUPERSTEP_PROFILE_R = {"mnist_2nn": 2, "mnist_cnn": 1}
# A profiled chunk short of the kernel's records (CUPTI lost a block of them)
# is profiled again, up to this many chunks in all (profile_chunk).
PROFILE_ATTEMPTS = 3
# run_lane profiles a chunk of this many replays after a device-sampling
# lane's run (the superstep spec, a 2NN); the run itself, with its warm-up
# and capture, stays out of the profile.
LANE_PROFILE_R = SUPERSTEP_PROFILE_R["mnist_2nn"]
# A captured round against an eager one from the same generator state: the
# 2NN plain and q8 rounds run no atomics and must be bitwise equal; top-k's
# fp32 REDs sum in their own order, so it is held to this fraction of the
# round's update in L2. cuDNN's default CNN backward is nondeterministic and
# 300 SGD steps carry its ulps far (two eager rounds from one state differ by
# about a tenth of the update; phase 22 prints it): the CNN is held bitwise
# with cudnn.deterministic on, on an engine of its own.
CAPTURE_RTOL = 1e-4
# superstep(20) against 20 x round() on the 2NN top-k lane, two engines built
# alike: both are replays of the same captured round, but every replay's REDs
# add in their own order, and 20 rounds of 300 SGD steps carry the ulps on.
# Each round's loss is held to TOPK_REPLAY_LOSS_RTOL of itself and the final
# params to TOPK_REPLAY_RTOL of the 20 rounds' update in L2; the generator
# states, which the draws advance whatever the values, bitwise. On an H100
# 4 repeats gave at most 1.6e-3 and 7.5e-3: about a sixth of each.
TOPK_REPLAY_LOSS_RTOL = 1e-2
TOPK_REPLAY_RTOL = 5e-2
# launch.train's checkpoint: Gemma-2B's reduced config (2 layers,
# d_model 256, vocab 512) in bf16 on the card, 2 FedAvg rounds.
LM_CKPT_ARGV = ["--arch", "gemma-2b", "--n-layers", "2", "--dtype", "bfloat16", "--groups", "2",
                "--local-steps", "2", "--global-batch", "4", "--seq", "128", "--rounds", "2",
                "--device", "cuda"]
# Phase 23, the paper's other models, one round each at full size. The CIFAR
# CNN through FederatedTrainer at the paper's CIFAR split (100 IID clients of
# 500 24x24x3 crops) and benchmarks/table3_cifar.py's lr; the word-LSTM
# through RoundEngine on make_word_corpus at its defaults (512 authors,
# V = 10,000), cut at the paper's unroll of 10 (its lr: SGD's usual 1.0 for
# an LSTM LM, no reference config names one).
CIFAR_DATA = dict(n_train=50_000, n_test=10_000, image_shape=(24, 24, 3), seed=11,
                  difficulty=1.2)
CIFAR_CLIENTS = 100
CIFAR_CFG = dict(C=0.1, E=5, B=50, lr=0.1, seed=0)
WORD_UNROLL = 10
WORD_CFG = dict(C=0.1, E=1, B=8, lr=1.0, seed=0)
# The Shakespeare example run as a user runs it, in a process of its own, for
# one round.
EXAMPLE_ROUNDS = 1
EXAMPLE_ARGV = ["-m", "repro_torch.examples.shakespeare_lstm", "--roles", "60",
                "--rounds", str(EXAMPLE_ROUNDS)]
# Card vs CPU at a reduced population (each model at its full width): the
# clients of a few roles / authors / CIFAR clients, rounds of 1 and of
# CHECK_STEPS steps held to UPDATE_RTOL_1 and UPDATE_RTOL_N as the MNIST
# models are. The embedding's backward on the card accumulates with atomics
# (index_put_), so the card's rounds are not bitwise; that is ulps, far
# inside UPDATE_RTOL_1.
REDUCED_CLIENTS = 12
REDUCED_C = 0.25
# The CIFAR CNN's 1-step round measured 2.0e-4 card vs CPU on an H100 (the
# LSTMs 3.7e-7): its 64-channel 5x5 convolutions sum 1,600 products an
# output in cuDNN's order, and a near-tie in a max-pool window routes a
# unit's gradient elsewhere. Its limit is GOSSIP_CNN_RTOL_1, backed by
# ``fp64_witness``: on an H100 the CPU's fp32 round measured 1.9e-6 from the
# fp64 round, the card's 2.0e-4 (conv2's weights 4.0e-4), the card's with
# cuDNN off 1.9e-6 and the card's fp64 round 3.7e-8: the gap is cuDNN's
# fp32 convolution algorithms, not the port.
PAPER_RTOL_1 = {"char_lstm": UPDATE_RTOL_1, "cifar_cnn": GOSSIP_CNN_RTOL_1,
                "word_lstm": UPDATE_RTOL_1}
# Phase 24, the buffered-async lane and the streamed pool at full size. (a)
# and (b): rounds (applies) a lane; (c): rounds a model, streamed against
# the device pool (the CNN under cudnn.deterministic, whose default backward
# is not); (f) the population gate of benchmarks/round_engine.py
# (_population_scaling) on the host-sampled lane: K = 10^5 clients of 16 x 64
# fp32 rows from a generator into shards of 4096 (~416 MB on disk), m = 20,
# 10 rounds, the process's RSS growth under 256 MB.
ASYNC_ROUNDS = 1
STREAMED_ROUNDS = {"mnist_2nn": 1, "mnist_cnn": 1}
POP_K, POP_ROWS, POP_D, POP_SHARD = 100_000, 16, 64, 4096
POP_M, POP_ROUNDS = 20, 10
POP_RSS_MB = 256.0
POP_WARM = 256                          # the warm-up population (population_gate)
# Phase 25, cohort sharding (RoundEngine(mesh=) over a torch.distributed
# client group) at full paper size: (b) each lane sharded over an NCCL world
# of one against the unsharded engine from the same seed, SHARD_ROUNDS rounds
# each; (c) the 2NN superstep, a chunk of SUPERSTEP_R; (d) SHARD_GLOO_WORLD
# ranks sharing the card under gloo, m = 10 over 3 ranks (12 slots, 2
# ghosts), the SHARD_GLOO_LANES; (e) from_spec with execution.mesh_axes.
# Lanes: (lane, model, spec whose codec or strategy it takes, codec override
# or None for a strategy's spec, kernel).
SHARD_ROUNDS = 1
SHARD_LANES = (
    ("mnist_2nn plain", "mnist_2nn", None, None, "fedavg_aggregate"),
    ("mnist_cnn plain", "mnist_cnn", None, None, "fedavg_aggregate"),
    ("mnist_2nn q8", "mnist_2nn", "mnist_2nn_noniid_q8", {}, "quantized_aggregate"),
    ("mnist_2nn q4", "mnist_2nn", "mnist_2nn_noniid_q8", {"bits": 4},
     "packed_quantized_aggregate"),
    ("mnist_2nn top-k", "mnist_2nn", "mnist_2nn_noniid_topk", {}, "sparse_aggregate"),
    ("mnist_2nn fedavgm", "mnist_2nn", "mnist_2nn_noniid_fedavgm", None, "fedavg_aggregate"),
)
# The reference's tolerances (tests/test_engine_sharded.py:163-240), (params,
# losses): fp32 reassociation of the server sum on the plain and FedAvgM
# lanes; a stochastic-rounding draw or a near-tied top-k member flipped by an
# ulp on the codec lanes.
SHARD_TOL = {"plain": (1e-5, 1e-5), "fedavgm": (1e-5, 1e-5), "q8": (1e-3, 1e-4),
             "q4": (2e-3, 1e-3), "top-k": (1e-3, 1e-4)}
SHARD_GLOO_WORLD = 3
SHARD_GLOO_LANES = ("mnist_2nn plain", "mnist_2nn q8")
SHARD_GLOO_DEADLINE_S = 300.0
# Phase 26, supersteps off the star lanes at full paper size, cut in rounds.
# (a) The gossip superstep: (model, spec whose sections it takes, topology:
# the spec's or "full"), each run in turns of R rounds, eager and captured.
# Every lane takes R = 2, the least that captures (rounds_per_step=1 is the
# eager loop), so that the script keeps inside its time limit on a slow
# host: the 2NN lanes' eager rounds are host-bound, 1.1-1.9 s each, and a
# CNN ring round holds the card ~3.2 s, eager or replayed, and its capture
# ~13-21 s (at GOSSIP_CNN_LR). The 2NN ring also runs a guarded chunk and a
# resume, each 2NN lane a profiled chunk of GOSSIP_PROFILE_R; the CNN
# ring no profile (one CNN ring round under the profiler took 79-109 s in
# phase 13).
GOSSIP_STEP_LANES = (
    ("mnist_2nn", "mnist_2nn_noniid_ring", None),
    ("mnist_2nn", "mnist_2nn_noniid_smallworld", None),
    ("mnist_2nn", "mnist_2nn_noniid_ring", "full"),
    ("mnist_cnn", "mnist_2nn_noniid_ring", None),
)
GOSSIP_STEP_R = {("mnist_2nn", "ring"): 2, ("mnist_2nn", "smallworld"): 2,
                 ("mnist_2nn", "full"): 2, ("mnist_cnn", "ring"): 2}
GOSSIP_PROFILE_R = 2
# Pairs of turns a lane, each pair held bitwise: (eager, captured), then
# (captured, eager) when a lane takes 2.
GOSSIP_TURN_PAIRS = {"mnist_2nn": 1, "mnist_cnn": 1}
# (b) Low-rank under device sampling on the 2NN: the card's sketch against
# the CPU's from the same seeds (the 32-bit words bitwise; the Gaussians, Box-
# Muller in fp64 rounded to fp32, within an fp32 ulp or two at |z| < 6);
# superstep(20) against 20 x round(), held to LOWRANK_REPLAY_RTOL of the loss
# and of the update (the einsum and the kernels hold no atomics: bitwise is
# expected, and printed).
SKETCH_ATOL = 1e-6
LOWRANK_R = 20
LOWRANK_HOST_ROUNDS = 1   # the host-sampled turn, beside one superstep chunk
LOWRANK_REPLAY_RTOL = 1e-5
# (c) The staged superstep: (model, spec whose codec the lane takes), chunks of
# STAGED_R in turns against the device pool's superstep (the CNN's chunk cut to
# 2: a CNN superstep round is ~0.42 s, and the lane runs four chunks), a
# profiled streamed 2NN chunk of STAGED_PROFILE_R, and phase 24 (f)'s
# population in one chunk of POP_ROUNDS.
STAGED_LANES = (("mnist_2nn", None), ("mnist_cnn", None), ("mnist_2nn", "mnist_2nn_noniid_q8"))
STAGED_R = {"mnist_2nn": 20, "mnist_cnn": 2}
STAGED_PROFILE_R = 2
# (d) from_spec: one chunk of this many rounds a spec.
FROM_SPEC_R = 2


def require(cond: bool, msg: str) -> None:
    if not cond:
        raise AssertionError(msg)


_PHASES = []


def phase(title: str) -> None:
    """Start a phase, and print the seconds the one before it took."""
    now = time.perf_counter()
    if _PHASES:
        print(f"  [{_PHASES[-1][0]}: {now - _PHASES[-1][1]:.1f} s]")
    _PHASES.append((title.split(" ", 1)[0].rstrip(".:"), now))
    print(f"\n== {title}", flush=True)


def nvidia_smi_line() -> str:
    out = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
        capture_output=True, text=True, timeout=60, check=True,
    ).stdout.strip().splitlines()
    return out[0].strip()


# ---------------------------------------------------------------------------
# phase 3: kernel vs plain on the card
# ---------------------------------------------------------------------------

def bf16_ulp(v: torch.Tensor) -> torch.Tensor:
    """One bf16 ulp at each |v| (8 significant bits)."""
    mag = v.abs().clamp_min(2.0 ** -126)
    return torch.exp2(torch.floor(torch.log2(mag)) - 7)


def make_case(K, N, dtype, *, ghosts=0, misaligned=False, seed=0):
    g = torch.Generator(device="cuda").manual_seed(seed)
    if misaligned:   # a contiguous view whose first element is one element off
        base = torch.empty(K * N + 1, device="cuda", dtype=torch.float32)
        x = base[1:].view(K, N)
        x.copy_(torch.randn((K, N), generator=g, device="cuda"))
    else:
        x = torch.randn((K, N), generator=g, device="cuda")
    w = np.random.default_rng(seed).uniform(0.1, 5.0, K).astype(np.float32)
    if ghosts:
        x[K - ghosts:] = 1e4
        w[K - ghosts:] = 0.0
    w = torch.from_numpy(w / w.sum()).cuda()
    if dtype == torch.bfloat16:
        if misaligned:
            base16 = torch.empty(K * N + 1, device="cuda", dtype=torch.bfloat16)
            xb = base16[1:].view(K, N)
            xb.copy_(x)
            x = xb
        else:
            x = x.to(torch.bfloat16)
    return x, w


def check_fedavg_aggregate():
    from repro_torch.kernels.fedavg_agg import (
        access_width,
        fedavg_aggregate,
        fedavg_aggregate_ref,
    )

    before = fedavg_aggregate.launches
    cases = []
    for dtype in (torch.float32, torch.bfloat16):
        for K in (1, 2, 10, 17):
            for N in (1, 1000, 4097, 199_210, 1_663_370):
                cases.append(dict(K=K, N=N, dtype=dtype))
        for K in (2, 10, 17):
            for N in (1000, 1_663_370):
                cases.append(dict(K=K, N=N, dtype=dtype, ghosts=max(1, K // 4)))
        for N in (1000, 199_210):
            cases.append(dict(K=10, N=N, dtype=dtype, misaligned=True))
    # the paper's other models' rounds and the async apply, fp32 as their
    # engines average
    cases += [dict(K=K, N=N, dtype=torch.float32) for K, N in AGG_SHAPES.values()]
    worst_fp32 = 0.0
    main_err = 0.0
    worst_bf16 = 0.0
    for i, c in enumerate(cases):
        x, w = make_case(c["K"], c["N"], c["dtype"], ghosts=c.get("ghosts", 0),
                         misaligned=c.get("misaligned", False), seed=i)
        out = fedavg_aggregate(x, w)
        vec = access_width(x, out)
        torch.cuda.synchronize()
        require(out.shape == (c["N"],) and out.dtype == c["dtype"], f"bad output for {c}")
        tag = " ghosts" if c.get("ghosts") else (" misaligned" if c.get("misaligned") else "")
        # fp32 sums over K rows in another order (fma): 1e-6 of the input scale
        sum_tol = 1e-6 * float(x[: c["K"] - c.get("ghosts", 0)].float().abs().max())
        if c["dtype"] == torch.float32:
            ref = fedavg_aggregate_ref(x, w)
            err = float((out - ref).abs().max())
            ok = err <= sum_tol
            worst_fp32 = max(worst_fp32, err)
            if (c["K"] == MAIN_K and c["N"] in MAIN_N.values()
                    or (c["K"], c["N"]) in AGG_SHAPES.values()) and not tag:
                main_err = max(main_err, err)
            detail = f"max_abs_err={err:.3e} tol={sum_tol:.3e}"
        else:
            # plus one rounding at the store: one bf16 ulp of the fp32 sum
            ref32 = fedavg_aggregate_ref(x.float(), w)       # fp32-accumulated, unrounded
            ulps = float(((out.float() - ref32).abs() / bf16_ulp(ref32)).max())
            share = float(((out.float() - ref32).abs() / (bf16_ulp(ref32) + sum_tol)).max())
            ok = share <= 1.0
            worst_bf16 = max(worst_bf16, share)
            detail = f"max_err={share:.3f} of (1 bf16 ulp + tol), {ulps:.3f} ulp"
        print(f"  K={c['K']:3d} N={c['N']:8d} {str(c['dtype'])[6:]:8s} vec={vec}{tag}: "
              f"{detail} {'ok' if ok else 'FAIL'}")
        if not ok:
            raise AssertionError(f"fedavg_aggregate disagrees with its plain version: {c}")
    n_launched = fedavg_aggregate.launches - before
    require(n_launched == len(cases), f"{n_launched} launches for {len(cases)} cases")

    # refusals: none of these may launch
    x, w = make_case(3, 64, torch.float32)
    refusals = {
        "unnormalized CPU weights": lambda: fedavg_aggregate(x.cpu(), torch.tensor([1.0, 2.0, 3.0])),
        "float64 storage": lambda: fedavg_aggregate(x.double(), w),
        "float16 storage": lambda: fedavg_aggregate(x.half(), w),
        "non-contiguous": lambda: fedavg_aggregate(x.t().contiguous().t(), w),
        "weights on another device": lambda: fedavg_aggregate(x, w.cpu()),
        "accum_dtype=bfloat16 on CUDA": lambda: fedavg_aggregate(x, w, accum_dtype=torch.bfloat16),
    }
    before = fedavg_aggregate.launches
    for name, fn in refusals.items():
        try:
            fn()
        except (TypeError, ValueError) as e:
            print(f"  refuses {name}: {type(e).__name__}")
        else:
            raise AssertionError(f"fedavg_aggregate accepted {name}")
    require(fedavg_aggregate.launches == before, "a refused call launched the kernel")
    print(f"kernels: fedavg_aggregate cuda ok ({len(cases)} cases; fp32 max_abs_err "
          f"{worst_fp32:.3e} within 1e-6*max|x|; bf16 max error {worst_bf16:.3f} of "
          f"1 bf16 ulp + 1e-6*max|x|; {len(refusals)} refusals)")
    return main_err


def counters():
    from repro_torch.kernels.fedavg_agg import fedavg_aggregate
    from repro_torch.kernels.quantized_agg import (
        packed_quantized_aggregate,
        quantized_aggregate,
    )
    from repro_torch.kernels.flash_attention import flash_attention
    from repro_torch.kernels.gossip_mix import gossip_mix
    from repro_torch.kernels.sparse_agg import sparse_aggregate
    from repro_torch.kernels.ssm_scan import ssm_scan, ssm_scan_bwd
    from repro_torch.kernels.ce_loss import ce_probs, fused_cross_entropy

    return {f.__name__: f for f in (fedavg_aggregate, quantized_aggregate,
                                    packed_quantized_aggregate, sparse_aggregate, gossip_mix,
                                    flash_attention, ssm_scan, fused_cross_entropy, ce_probs,
                                    ssm_scan_bwd)}


def launch_counts():
    return {name: f.launches for name, f in counters().items()}


# Every hand kernel by its own name, as ptxas and the profiler's records give
# it (a name that contains another comes first), and the one each wrapper of
# the superstep lanes launches on its main route.
HAND_KERNELS = ("qagg_stream_kernel", "packed_qagg_kernel", "qagg_kernel",
                "fedavg_agg_kernel", "sparse_agg_fused_kernel", "sparse_agg_kernel",
                "gossip_mix_dense_kernel", "gossip_mix_kernel", "flash_fwd_mma_kernel",
                "flash_fwd_kernel", "ssm_scan_ring_kernel", "ssm_scan_kernel",
                "ssm_scan_bwd_reduce_kernel", "ssm_scan_bwd_kernel",
                "ce_fwd_mma_kernel", "ce_probs_mma_kernel", "ce_probs_kernel",
                "ce_partial_kernel", "ce_merge_kernel")
MAIN_ROUTE_KERNEL = {"fedavg_aggregate": "fedavg_agg_kernel",
                     "quantized_aggregate": "qagg_stream_kernel",
                     "sparse_aggregate": "sparse_agg_fused_kernel"}


def kernel_records(ops):
    """{hand kernel: records} among a profile's device ops, matched on the
    kernel's own name (``void (anonymous namespace)::qagg_stream_kernel<8>(...)``)."""
    found = {}
    for e in ops:
        m = re.match(r"(?:void\s+)?(?:\(anonymous namespace\)::)?(?:\w+::)*(\w+)", e.name)
        if m and m.group(1) in HAND_KERNELS:
            found[m.group(1)] = found.get(m.group(1), 0) + 1
    return found


def reset_counts():
    for f in counters().values():
        f.launches = 0
    for name in ("flash_attention", "fused_cross_entropy", "ce_probs"):
        counters()[name].tc_launches = 0
    counters()["gossip_mix"].dense_launches = 0
    for name in ("quantized_aggregate", "packed_quantized_aggregate"):
        counters()[name].stream_launches = 0
    counters()["sparse_aggregate"].fused_launches = 0
    for name in PARTIAL_KERNELS:
        counters()[name].partial_launches = 0
    lanes = counters()["ssm_scan"].lane_launches
    for k in lanes:
        lanes[k] = 0


def flash_tc_launches():
    """Launches of flash_attention's tensor-core kernel (its ``launches``
    counts both routes)."""
    return counters()["flash_attention"].tc_launches


def ce_tc_launches():
    """Launches of fused_cross_entropy's tensor-core kernel (its
    ``launches`` counts both routes)."""
    return counters()["fused_cross_entropy"].tc_launches


def probs_tc_launches():
    """Launches of ce_probs' tensor-core kernel (its ``launches`` counts
    both routes)."""
    return counters()["ce_probs"].tc_launches


def check_refusals(name, wrapper, refusals):
    """Each refused call raises TypeError or ValueError and launches nothing."""
    before = wrapper.launches
    for what, fn in refusals.items():
        try:
            fn()
        except (TypeError, ValueError) as e:
            print(f"  {name} refuses {what}: {type(e).__name__}")
        else:
            raise AssertionError(f"{name} accepted {what}")
    require(wrapper.launches == before, f"a refused {name} call launched the kernel")
    return len(refusals)


def normalized(K, ghosts=0, seed=0):
    w = np.random.default_rng(seed).uniform(0.1, 5.0, K).astype(np.float32)
    if ghosts:
        w[K - ghosts:] = 0.0
    return torch.from_numpy(w / w.sum()).cuda()


def random_codes(K, n_pad, dtype, seed):
    """uint8 or uint16 codes, drawn on the host and copied to the card."""
    g = torch.Generator().manual_seed(seed)
    top = 256 if dtype == torch.uint8 else 65536
    return torch.randint(0, top, (K, n_pad), generator=g, dtype=torch.int32).to(dtype).cuda()


def ranges(K, C, seed, ghosts=0):
    g = torch.Generator(device="cuda").manual_seed(seed)
    lo = torch.randn((K, C), generator=g, device="cuda")
    scale = torch.rand((K, C), generator=g, device="cuda") * 2
    scale[torch.rand((K, C), generator=g, device="cuda") < 0.2] = 0.0   # constant chunks
    if ghosts:
        lo[K - ghosts:] = 1e4
    return lo, scale


def sum_check(name, tag, out, ref, term_max):
    """fp32 sums over K rows in another order (fma): 1e-6 of the largest term."""
    tol = 1e-6 * term_max
    err = float((out - ref).abs().max())
    ok = err <= tol
    print(f"  {tag}: max_abs_err={err:.3e} tol={tol:.3e} {'ok' if ok else 'FAIL'}")
    if not ok:
        raise AssertionError(f"{name} disagrees with its plain version: {tag}")
    return err


def wire_routed(name, tag, payload, lo, scale, w, ref, term_max, *, bits, chunk, levels):
    """One wire-kernel case: the wrapper on the route ``_route`` picks, then,
    where the stream route takes the case, each route forced through
    ``_launch``; every output held to ``ref``, and the two forced outputs to
    each other bit for bit. Returns the worst error and the route."""
    from repro_torch.kernels.quantized_agg import (
        _launch,
        _out,
        _route,
        packed_quantized_aggregate,
        quantized_aggregate,
    )

    words = payload.dtype == torch.int32
    wrapper = packed_quantized_aggregate if words else quantized_aggregate
    kw = dict(bits=bits, chunk=chunk, levels=levels)
    route = _route(payload, _out(payload, lo, chunk), chunk=chunk, bits=bits, K=payload.shape[0])
    before = (wrapper.launches, wrapper.stream_launches)
    out = (wrapper(payload, lo, scale, w, **kw) if words else
           wrapper(payload, lo, scale, w, chunk=chunk, levels=levels))
    err = sum_check(name, f"{tag} routed {route}", out, ref, term_max)
    if route == "stream":
        forced = {r: _launch(payload, lo, scale, w, _out(payload, lo, chunk), route=r, **kw)
                  for r in ("general", "stream")}
        for r, got in forced.items():
            err = max(err, sum_check(name, f"{tag} forced {r}", got, ref, term_max))
        # the same fma chain in the same k order, on exact decodes
        require(torch.equal(forced["general"], forced["stream"]),
                f"{name} {tag}: the two routes differ")
    launched = (wrapper.launches - before[0], wrapper.stream_launches - before[1])
    want = (3, 2) if route == "stream" else (1, 0)
    require(launched == want, f"{name} {tag}: (launches, stream launches) {launched}, "
                              f"want {want}")
    return err, route


def check_quantized_aggregate():
    from repro_torch.kernels.quantized_agg import (
        STREAM_MAX_K,
        access_width,
        dequantize_ref,
        quantized_aggregate,
        quantized_aggregate_ref,
    )

    name = "quantized_aggregate"
    cases = []
    for dtype in (torch.uint8, torch.uint16):
        for K in (1, 2, 10, 17):
            for N, chunk in ((1000, CHUNK), (4097, 16), (100, 30), *((n, CHUNK) for n in MAIN_N.values())):
                cases.append(dict(K=K, N=N, chunk=chunk, dtype=dtype))
        for K in (2, 10, 17):
            for N in (1000, MAIN_N["mnist_2nn"]):
                cases.append(dict(K=K, N=N, chunk=CHUNK, dtype=dtype, ghosts=max(1, K // 4)))
        cases.append(dict(K=10, N=1000, chunk=CHUNK, dtype=dtype, misaligned=True))
        # the most rows the stream route takes, and one more (the general route)
        for K in (STREAM_MAX_K, STREAM_MAX_K + 1):
            cases.append(dict(K=K, N=MAIN_N["mnist_2nn"], chunk=CHUNK, dtype=dtype))
    before = (quantized_aggregate.launches, quantized_aggregate.stream_launches)
    main_err = worst = 0.0
    routes = {"stream": 0, "general": 0}
    for i, c in enumerate(cases):
        K, chunk, ghosts = c["K"], c["chunk"], c.get("ghosts", 0)
        C = -(-c["N"] // chunk)
        codes = random_codes(K, C * chunk, c["dtype"], seed=i)
        if c.get("misaligned"):   # a contiguous view one element off 16-byte alignment
            base = torch.empty(K * C * chunk + 1, dtype=c["dtype"], device="cuda")
            codes = base[1:].view(K, C * chunk).copy_(codes)
        levels = 255 if c["dtype"] == torch.uint8 else 65535
        lo, scale = ranges(K, C, seed=i, ghosts=ghosts)
        w = normalized(K, ghosts, seed=i)
        ref = quantized_aggregate_ref(codes, lo, scale, w, chunk=chunk, levels=levels)
        dense = dequantize_ref(codes[: K - ghosts], lo[: K - ghosts], scale[: K - ghosts],
                               chunk=chunk, levels=levels)
        tag = (f"K={K:2d} N={c['N']:8d} chunk={chunk:3d} {str(c['dtype'])[6:]:6s} "
               f"vec={access_width(codes, ref, chunk):2d}"
               + (" ghosts" if ghosts else "") + (" misaligned" if c.get("misaligned") else ""))
        err, route = wire_routed(name, tag, codes, lo, scale, w, ref,
                                 float(dense.abs().max()), bits=8 * codes.element_size(),
                                 chunk=chunk, levels=levels)
        routes[route] += 1
        worst = max(worst, err)
        if K == MAIN_K and c["N"] in MAIN_N.values() and chunk == CHUNK and not ghosts:
            require(route == "stream", f"{name} {tag}: the main shape took the {route} route")
        if K == MAIN_K and c["N"] in MAIN_N.values() and c["dtype"] == torch.uint8 and not ghosts:
            main_err = max(main_err, err)
    launched = (quantized_aggregate.launches - before[0],
                quantized_aggregate.stream_launches - before[1])
    require(launched == (len(cases) + 2 * routes["stream"], 2 * routes["stream"]),
            f"{name}: {launched} launches for {len(cases)} cases")
    codes = random_codes(3, 2 * 16, torch.uint8, seed=0)
    lo, scale = ranges(3, 2, seed=0)
    w = normalized(3)
    n_ref = check_refusals(name, quantized_aggregate, {
        "unnormalized CPU weights": lambda: quantized_aggregate(
            codes.cpu(), lo.cpu(), scale.cpu(), torch.tensor([1.0, 2.0, 3.0]), chunk=16, levels=255),
        "int32 codes": lambda: quantized_aggregate(codes.int(), lo, scale, w, chunk=16, levels=255),
        "ragged codes": lambda: quantized_aggregate(codes[:, :30], lo, scale, w, chunk=16, levels=255),
        "float64 lo": lambda: quantized_aggregate(codes, lo.double(), scale, w, chunk=16, levels=255),
        "non-contiguous codes": lambda: quantized_aggregate(
            codes.t().contiguous().t(), lo, scale, w, chunk=16, levels=255),
        "weights on another device": lambda: quantized_aggregate(
            codes, lo, scale, w.cpu(), chunk=16, levels=255),
        "accum_dtype=bfloat16 on CUDA": lambda: quantized_aggregate(
            codes, lo, scale, w, chunk=16, levels=255, accum_dtype=torch.bfloat16),
    })
    print(f"kernels: {name} cuda ok ({len(cases)} cases: {routes['stream']} on the stream "
          f"route and also through both forced, {routes['general']} on the general route; "
          f"max_abs_err {worst:.3e} within 1e-6*max|term|; {n_ref} refusals)")
    return main_err


def check_packed_quantized_aggregate():
    from repro_torch.kernels.quantized_agg import (
        STREAM_MAX_K,
        dequantize_ref,
        packed_quantized_aggregate,
        packed_quantized_aggregate_ref,
        unpack_ref,
    )
    from repro_torch.utils.bitpack import words_per_chunk

    name = "packed_quantized_aggregate"
    cases = [dict(K=K, N=N, chunk=chunk, bits=bits)
             for bits in range(1, 16) for K in (1, 2, 10, 17)
             for N, chunk in ((250, 30), (1000, CHUNK))]
    cases += [dict(K=10, N=N, chunk=CHUNK, bits=bits)
              for N in MAIN_N.values() for bits in (1, 2, 3, 4, 12)]
    cases += [dict(K=K, N=1000, chunk=CHUNK, bits=4, ghosts=max(1, K // 4)) for K in (2, 10, 17)]
    cases += [dict(K=K, N=MAIN_N["mnist_2nn"], chunk=CHUNK, bits=4)
              for K in (STREAM_MAX_K, STREAM_MAX_K + 1)]
    before = (packed_quantized_aggregate.launches, packed_quantized_aggregate.stream_launches)
    main_err = worst = 0.0
    routes = {"stream": 0, "general": 0}
    for i, c in enumerate(cases):
        K, chunk, bits, ghosts = c["K"], c["chunk"], c["bits"], c.get("ghosts", 0)
        C = -(-c["N"] // chunk)
        g = torch.Generator(device="cuda").manual_seed(i)
        # any 32-bit pattern is a valid word: slack bits are ignored by both
        words = torch.randint(-2**31, 2**31, (K, C * words_per_chunk(chunk, bits)),
                              generator=g, dtype=torch.int32, device="cuda")
        lo, scale = ranges(K, C, seed=i, ghosts=ghosts)
        w = normalized(K, ghosts, seed=i)
        kw = dict(bits=bits, chunk=chunk, levels=2**bits - 1)
        ref = packed_quantized_aggregate_ref(words, lo, scale, w, **kw)
        real = K - ghosts
        dense = dequantize_ref(unpack_ref(words[:real], bits=bits, chunk=chunk),
                               lo[:real], scale[:real], chunk=chunk, levels=2**bits - 1)
        tag = (f"bits={bits:2d} K={K:2d} N={c['N']:8d} chunk={chunk:3d}"
               + (" ghosts" if ghosts else ""))
        err, route = wire_routed(name, tag, words, lo, scale, w, ref, float(dense.abs().max()),
                                 **kw)
        routes[route] += 1
        worst = max(worst, err)
        if K == MAIN_K and c["N"] in MAIN_N.values() and bits in (1, 2, 4):
            require(route == "stream", f"{name} {tag}: the main shape took the {route} route")
        if K == MAIN_K and c["N"] in MAIN_N.values() and bits == 4:
            main_err = max(main_err, err)
    launched = (packed_quantized_aggregate.launches - before[0],
                packed_quantized_aggregate.stream_launches - before[1])
    require(launched == (len(cases) + 2 * routes["stream"], 2 * routes["stream"]),
            f"{name}: {launched} launches for {len(cases)} cases")
    words = torch.zeros((3, 4), dtype=torch.int32, device="cuda")
    lo, scale = ranges(3, 2, seed=0)
    w = normalized(3)
    kw = dict(bits=4, chunk=16, levels=15)
    n_ref = check_refusals(name, packed_quantized_aggregate, {
        "unnormalized CPU weights": lambda: packed_quantized_aggregate(
            words.cpu(), lo.cpu(), scale.cpu(), torch.tensor([1.0, 2.0, 3.0]), **kw),
        "bits=16": lambda: packed_quantized_aggregate(words, lo, scale, w, bits=16, chunk=16,
                                                      levels=65535),
        "uint8 words": lambda: packed_quantized_aggregate(words.to(torch.uint8), lo, scale, w, **kw),
        "ragged words": lambda: packed_quantized_aggregate(words[:, :3], lo, scale, w, **kw),
        "non-contiguous scale": lambda: packed_quantized_aggregate(
            words, lo, scale.t().contiguous().t(), w, **kw),
        "lo on another device": lambda: packed_quantized_aggregate(words, lo.cpu(), scale, w, **kw),
        "accum_dtype=bfloat16 on CUDA": lambda: packed_quantized_aggregate(
            words, lo, scale, w, accum_dtype=torch.bfloat16, **kw),
    })
    print(f"kernels: {name} cuda ok ({len(cases)} cases, bits 1..15: {routes['stream']} on the "
          f"stream route and also through both forced, {routes['general']} on the general "
          f"route; max_abs_err {worst:.3e} within 1e-6*max|term|; {n_ref} refusals)")
    return main_err


def sparse_case(K, n, k, dtype, seed, *, unique=True, ghosts=0, out_of_range=False,
                misaligned=None):
    """(idx, vals, w) on the card; ``misaligned``: "idx" or "vals" is a
    contiguous view one element past a 16-byte boundary."""
    g = torch.Generator(device="cuda").manual_seed(seed)
    if unique:
        idx = torch.stack([torch.randperm(n, generator=g, device="cuda")[:k] for _ in range(K)])
    else:   # drawn with replacement: duplicates within a client
        idx = torch.randint(0, n, (K, k), generator=g, device="cuda")
    idx = idx.to(torch.int32)
    if out_of_range:
        idx[0, :2] = torch.tensor([-1, n], dtype=torch.int32)
    vals = torch.randn((K, k), generator=g, device="cuda")
    if ghosts:
        vals[K - ghosts:] = 1e4
    vals = vals.to(dtype)
    if misaligned == "idx":
        idx = torch.empty(K * k + 1, dtype=torch.int32, device="cuda")[1:].view(K, k).copy_(idx)
    if misaligned == "vals":
        vals = torch.empty(K * k + 1, dtype=dtype, device="cuda")[1:].view(K, k).copy_(vals)
    return idx.contiguous(), vals.contiguous(), normalized(K, ghosts, seed)


def sparse_routed(name, tag, idx, vals, w, n, ref, term_max):
    """One sparse case: the wrapper on the route ``_route`` picks, then, where
    the fused route takes the case, each route forced through ``_launch``;
    every output held to ``ref`` (atomics add in an order that varies from
    run to run: not bitwise). Returns the worst error and the route."""
    from repro_torch.kernels.sparse_agg import ROUTES, _launch, _route, sparse_aggregate

    K, k = idx.shape
    route = _route(idx, vals, torch.empty(n, device="cuda"), K=K, k=k)
    before = (sparse_aggregate.launches, sparse_aggregate.fused_launches)
    err = sum_check(name, f"{tag} routed {route}", sparse_aggregate(idx, vals, w, n), ref,
                    term_max)
    if route == "fused":
        for r in ROUTES:
            got = _launch(idx, vals, w, torch.empty(n, device="cuda"), r)
            err = max(err, sum_check(name, f"{tag} forced {r}", got, ref, term_max))
    launched = (sparse_aggregate.launches - before[0],
                sparse_aggregate.fused_launches - before[1])
    want = (3, 2) if route == "fused" else (1, 0)
    require(launched == want, f"{name} {tag}: (launches, fused launches) {launched}, "
                              f"want {want}")
    return err, route


def check_sparse_aggregate():
    from repro_torch.kernels.sparse_agg import sparse_aggregate, sparse_aggregate_ref

    name = "sparse_aggregate"
    cases = []
    for dtype in (torch.float32, torch.bfloat16):
        for K in (1, 2, 10, 17):
            for n in (37, 513, *MAIN_N.values()):
                cases.append(dict(K=K, n=n, dtype=dtype))
        for K in (2, 10, 17):
            cases.append(dict(K=K, n=MAIN_N["mnist_2nn"], dtype=dtype, ghosts=max(1, K // 4)))
        cases.append(dict(K=10, n=513, dtype=dtype, unique=False))
        cases.append(dict(K=10, n=5000, dtype=dtype, unique=False, out_of_range=True))
        # the same on the fused route (k = 256)
        cases.append(dict(K=10, n=5120, dtype=dtype, unique=False))
        cases.append(dict(K=10, n=5120, dtype=dtype, unique=False, out_of_range=True))
        # misaligned views: the scatter route at the main 2NN shape
        for which in ("idx", "vals"):
            cases.append(dict(K=10, n=MAIN_N["mnist_2nn"], dtype=dtype, misaligned=which))
    main_err = worst = 0.0
    routes = {"fused": 0, "scatter": 0}
    for i, c in enumerate(cases):
        K, n, ghosts = c["K"], c["n"], c.get("ghosts", 0)
        k = max(n * 5 // 100, 1)
        idx, vals, w = sparse_case(K, n, k, c["dtype"], seed=i, unique=c.get("unique", True),
                                   ghosts=ghosts, out_of_range=c.get("out_of_range", False),
                                   misaligned=c.get("misaligned"))
        ref = sparse_aggregate_ref(idx, vals, w, n)
        tag = (f"K={K:2d} n={n:8d} k={k:6d} {str(c['dtype'])[6:]:8s}"
               + (" ghosts" if ghosts else "") + (" duplicates" if not c.get("unique", True) else "")
               + (" out-of-range dropped" if c.get("out_of_range") else "")
               + (f" misaligned {c['misaligned']}" if c.get("misaligned") else ""))
        err, route = sparse_routed(name, tag, idx, vals, w, n, ref,
                                   float(vals[: K - ghosts].float().abs().max()))
        routes[route] += 1
        worst = max(worst, err)
        main = K == MAIN_K and n in MAIN_N.values() and not c.get("misaligned")
        if main:
            require(route == "fused", f"{name} {tag}: the main shape took the {route} route")
        if main and c["dtype"] == torch.float32:
            main_err = max(main_err, err)
    require(routes["scatter"] > 0 and routes["fused"] > 0, f"{name}: routes {routes}")
    idx, vals, w = sparse_case(3, 64, 4, torch.float32, seed=0)
    n_ref = check_refusals(name, sparse_aggregate, {
        "unnormalized CPU weights": lambda: sparse_aggregate(
            idx.cpu(), vals.cpu(), torch.tensor([1.0, 2.0, 3.0]), 64),
        "int64 indices": lambda: sparse_aggregate(idx.long(), vals, w, 64),
        "float16 values": lambda: sparse_aggregate(idx, vals.half(), w, 64),
        "mismatched shapes": lambda: sparse_aggregate(idx[:, :3], vals, w, 64),
        "non-contiguous values": lambda: sparse_aggregate(
            idx, vals.t().contiguous().t(), w, 64),
        "weights on another device": lambda: sparse_aggregate(idx, vals, w.cpu(), 64),
        "accum_dtype=bfloat16 on CUDA": lambda: sparse_aggregate(
            idx, vals, w, 64, accum_dtype=torch.bfloat16),
    })
    print(f"kernels: {name} cuda ok ({len(cases)} cases: {routes['fused']} on the fused "
          f"route and also through both forced, {routes['scatter']} on the scatter route; "
          f"max_abs_err {worst:.3e} within 1e-6*max|term|; {n_ref} refusals)")
    return main_err


def gossip_plans(n):
    """name -> MixingPlan at n nodes: the ring, the small world of
    specs/mnist_2nn_noniid_smallworld.json and the full graph, where the kind
    takes n nodes."""
    from repro_torch.core import topology as topo

    kinds = {"ring": topo.RingTopology(degree=2),
             "smallworld": topo.SmallWorldTopology(degree=4, rewire=0.2, seed=0),
             "full": topo.FullTopology()}
    out = {}
    for name, t in kinds.items():
        if name == "ring" and n < 3 or name == "smallworld" and n < 5:
            continue
        out[name] = t.build(n)
    return out


def odd_plan(n, kind, seed):
    """(idx, weight) with duplicate ids, ids outside [0, n), or a ring plan
    widened with dead padded slots; every row sums to 1."""
    r = np.random.default_rng(seed)
    if kind == "padded":
        plan = gossip_plans(n)["ring"]
        idx = np.concatenate([plan.idx, np.tile(np.arange(n, dtype=np.int32)[:, None], (1, 3))], 1)
        w = np.concatenate([plan.weight, np.zeros((n, 3), np.float32)], 1)
        return idx, w
    D = 6
    idx = r.integers(0, n, (n, D)).astype(np.int32)
    if kind == "duplicates":
        idx[:, 1] = idx[:, 0]
    else:   # out of range: -1, n and a large id on every row
        idx[:, :3] = np.array([-1, n, 10 * n + 3], np.int32)
    w = r.uniform(0.1, 1.0, (n, D))
    return idx, (w / w.sum(axis=1, keepdims=True)).astype(np.float32)


def gossip_tol(x, w):
    """fp32 sums of the row's terms in another order: for weights summing to
    at most 1, each side errs by at most D roundings of max|x|."""
    D = w.shape[1]
    return 2 * D * 2.0 ** -24 * float(x.float().abs().max())


def gossip_routed(x, idx, w, route=None):
    """gossip_mix(x, idx, w), required to launch once through the route
    ``_route`` picks, or through ``route``'s kernel forced by the module's
    private launcher; (out, the route taken)."""
    from repro_torch.kernels.gossip_mix import _launch, _route, gossip_mix

    n, dense = gossip_mix.launches, gossip_mix.dense_launches
    taken = route or _route(x, idx, w)
    out = gossip_mix(x, idx, w) if route is None else _launch(x, idx, w, route)
    require(gossip_mix.launches == n + 1
            and gossip_mix.dense_launches == dense + (taken == "dense"),
            f"gossip_mix took the wrong route (want {taken}) for n={x.shape[0]} "
            f"D={idx.shape[1]}")
    return out, taken


def check_gossip_mix():
    from repro_torch.kernels.gossip_mix import MAX_NODES, gossip_mix, gossip_mix_ref, launch_config

    name = "gossip_mix"
    cases = []
    for dtype in (torch.float32, torch.bfloat16):
        for n in (2, 3, 17, 100):
            for N in (1, 33, 4097, *MAIN_N.values()):
                for plan in gossip_plans(n):
                    cases.append(dict(n=n, N=N, dtype=dtype, plan=plan))
        for N in (33, 4097, MAIN_N["mnist_2nn"]):   # the dense route's K panels and M chunks
            cases.append(dict(n=MAX_NODES, N=N, dtype=dtype, plan="full"))
        for kind in ("duplicates", "out_of_range", "padded"):
            for n, N in ((17, 4097), (100, MAIN_N["mnist_2nn"])):
                cases.append(dict(n=n, N=N, dtype=dtype, plan=kind))
        for plan in ("ring", "smallworld", "full"):
            for N in MAIN_N.values():
                cases.append(dict(n=100, N=N, dtype=dtype, plan=plan, misaligned=True))
    before = gossip_mix.launches
    main_err = worst = worst_bf16 = 0.0
    n_launched, by_route = 0, {"gather": 0, "dense": 0}
    for i, c in enumerate(cases):
        n, N, dtype = c["n"], c["N"], c["dtype"]
        if c["plan"] in ("duplicates", "out_of_range", "padded"):
            idx, w = odd_plan(n, c["plan"], seed=i)
        else:
            p = gossip_plans(n)[c["plan"]]
            idx, w = p.idx, p.weight
        idx, w = torch.from_numpy(idx).cuda(), torch.from_numpy(w).cuda()
        g = torch.Generator(device="cuda").manual_seed(i)
        if c.get("misaligned"):   # a contiguous view one element off 16-byte alignment
            x = torch.empty(n * N + 1, device="cuda", dtype=dtype)[1:].view(n, N)
            x.copy_(torch.randn((n, N), generator=g, device="cuda"))
        else:
            x = torch.randn((n, N), generator=g, device="cuda").to(dtype)
        tol = gossip_tol(x, w)
        ref32 = gossip_mix_ref(x.float(), idx, w)
        # the wrapper's route, then (on the main plans at n = 100) each route forced
        forced = (n == N_NODES and N in MAIN_N.values()
                  and c["plan"] in ("ring", "smallworld", "full"))
        for route in (None, "gather", "dense") if forced else (None,):
            out, taken = gossip_routed(x, idx, w, route)
            torch.cuda.synchronize()
            n_launched += 1
            by_route[taken] += 1
            require(out.shape == (n, N) and out.dtype == dtype, f"bad output for {c}")
            cfg = launch_config(x, idx, out, taken)
            tag = (f"n={n:4d} N={N:8d} D={idx.shape[1]:4d} {str(dtype)[6:]:8s} "
                   f"{c['plan']:12s} {'forced ' if route else ''}{taken:6s} "
                   + " ".join(f"{k}={v}" for k, v in cfg.items() if k != "route")
                   + (" misaligned" if c.get("misaligned") else ""))
            if dtype == torch.float32:
                err = float((out - ref32).abs().max())
                ok = err <= tol
                worst = max(worst, err)
                if n == N_NODES and N in MAIN_N.values() and c["plan"] in ("ring", "smallworld"):
                    main_err = max(main_err, err)
                detail = f"max_abs_err={err:.3e} tol={tol:.3e}"
            else:
                # plus one rounding at the store: one bf16 ulp of the fp32 sum
                share = float(((out.float() - ref32).abs() / (bf16_ulp(ref32) + tol)).max())
                ok = share <= 1.0
                worst_bf16 = max(worst_bf16, share)
                detail = f"max_err={share:.3f} of (1 bf16 ulp + tol)"
            print(f"  {tag}: {detail} {'ok' if ok else 'FAIL'}")
            if not ok:
                raise AssertionError(f"{name} disagrees with its plain version: {c}, {taken}")
    require(gossip_mix.launches - before == n_launched, "one launch per case and route")

    ring = gossip_plans(4)["ring"]
    x = torch.randn((4, 64), device="cuda")
    idx, w = torch.from_numpy(ring.idx).cuda(), torch.from_numpy(ring.weight).cuda()
    big = torch.zeros((MAX_NODES + 1, 8), device="cuda")
    n_ref = check_refusals(name, gossip_mix, {
        "a non-stochastic CPU plan": lambda: gossip_mix(x.cpu(), idx.cpu(), w.cpu() * 2),
        "idx of another shape": lambda: gossip_mix(x, idx[:3].contiguous(), w[:3].contiguous()),
        "float16 x": lambda: gossip_mix(x.half(), idx, w),
        "int64 idx": lambda: gossip_mix(x, idx.long(), w),
        "non-contiguous x": lambda: gossip_mix(x.t().contiguous().t(), idx, w),
        "accum_dtype=bfloat16 on CUDA": lambda: gossip_mix(x, idx, w, accum_dtype=torch.bfloat16),
        f"{MAX_NODES + 1} nodes": lambda: gossip_mix(
            big, torch.arange(MAX_NODES + 1, dtype=torch.int32, device="cuda")[:, None],
            torch.ones((MAX_NODES + 1, 1), device="cuda")),
    })
    print(f"kernels: {name} cuda ok ({len(cases)} cases, {n_launched} launches: "
          f"{by_route['gather']} gather, {by_route['dense']} dense; fp32 max_abs_err "
          f"{worst:.3e} within 2*D*2^-24*max|x|; bf16 max error {worst_bf16:.3f} of 1 bf16 "
          f"ulp + that; {n_ref} refusals)")
    return main_err


# ---------------------------------------------------------------------------
# phase 4: timing
# ---------------------------------------------------------------------------

def flush_buffer():
    """The L2 flush's buffer (L2_FLUSH_BYTES), written once."""
    return torch.zeros(L2_FLUSH_BYTES // 4, device="cuda")


def time_ms(fn, flush, iters=200, warmup=20):
    """Median device time of ``fn`` over ``iters`` launches, each after an
    L2 flush (a read of ``flush``: clean lines), between CUDA events."""
    for _ in range(warmup):
        fn()
    starts = [torch.cuda.Event(enable_timing=True) for _ in range(iters)]
    ends = [torch.cuda.Event(enable_timing=True) for _ in range(iters)]
    for s, e in zip(starts, ends):
        flush.sum()
        s.record()
        fn()
        e.record()
    torch.cuda.synchronize()
    return float(np.median([s.elapsed_time(e) for s, e in zip(starts, ends)]))


def time_fedavg_aggregate():
    from repro_torch.kernels.fedavg_agg import (
        access_width,
        fedavg_aggregate,
        fedavg_aggregate_ref,
    )

    flush = flush_buffer()
    rows = {}
    shapes = {**{model: (MAIN_K, N) for model, N in MAIN_N.items()}, **AGG_SHAPES}
    for model, (K, N) in shapes.items():
        x, w = make_case(K, N, torch.float32, seed=7)
        nbytes = K * N * 4 + N * 4 + K * 4
        flops = 2 * K * N
        bound = max(nbytes / HBM_BYTES_PER_S, flops / FP32_FLOPS) * 1e3
        r = {
            "K": K, "N": N, "dtype": "float32",
            "ms": time_ms(lambda: fedavg_aggregate(x, w), flush),
            "plain_ms": time_ms(lambda: fedavg_aggregate_ref(x, w), flush),
            "library_ms": time_ms(lambda: torch.mv(x.t(), w), flush),
            "bound_ms": bound,
            "bound_by": "bytes" if nbytes / HBM_BYTES_PER_S >= flops / FP32_FLOPS else "operations",
            "vec": access_width(x, fedavg_aggregate(x, w)),
        }
        r["achieved_GBps"] = nbytes / (r["ms"] * 1e-3) / 1e9
        r["bound_share"] = r["bound_ms"] / r["ms"]
        rows[model] = r
        print(f"  {model}: K={K} N={N} fp32 vec={r['vec']} kernel_ms={r['ms']:.5f} "
              f"bound_ms={bound:.5f} ({r['bound_share']:.1%} of bound, "
              f"{r['achieved_GBps']:.0f} GB/s) plain_ms={r['plain_ms']:.5f} "
              f"library_ms={r['library_ms']:.5f} (torch.mv, yardstick only)")
        del x, w
    del flush
    return rows


def time_fedavg_training_leaves(arch="gemma-2b", n_layers=None, iters=50):
    """``fedavg_aggregate`` as one group average of ``arch`` (Gemma-2B
    whole; phase 31's cuts with ``n_layers``) launches it
    (``ops.tree_weighted_mean``: K = TRAIN_G groups, each bf16 leaf viewed
    (K, -1), equal weights), on zero-filled stacks of the leaves' real
    shapes: each leaf's time (the median of ``iters``), their sum and the
    largest leaf's, against the bound (the leaves' bytes, each read once
    and the average written once, over the HBM rate) and a one-call
    yardstick, ``torch.mv`` on the bf16 (N, K) view with bf16 weights
    (cuBLAS sums in fp32; 1 / K is exact in bf16 at K = 2)."""
    from repro_torch.configs import get_config
    from repro_torch.kernels.fedavg_agg import fedavg_aggregate
    from repro_torch.models.transformer import TransformerLM
    from repro_torch.utils.tree import tree_leaves

    flush = flush_buffer()
    K = TRAIN_G
    w = torch.full((K,), 1.0 / K, device="cuda")
    w16 = w.to(torch.bfloat16)
    require(torch.equal(w16.float(), w), "the group weights round in bf16")
    cfg = get_config(arch)
    if n_layers is not None:
        cfg = dataclasses.replace(cfg, n_layers=n_layers)
    shapes = [tuple(p.shape) for p in tree_leaves(
        TransformerLM(cfg, device="meta").param_shapes())]
    leaves = []
    for shape in shapes:
        x = torch.zeros((K, math.prod(shape)), dtype=torch.bfloat16, device="cuda")
        leaves.append({"shape": shape, "N": x.shape[1],
                       "ms": time_ms(lambda: fedavg_aggregate(x, w), flush, iters=iters,
                                     warmup=5),
                       "library_ms": time_ms(lambda: torch.mv(x.t(), w16), flush, iters=iters,
                                             warmup=5)})
        del x
    n_params = sum(leaf["N"] for leaf in leaves)
    nbytes = n_params * 2 * (K + 1)
    r = {"K": K, "dtype": "bfloat16", "leaves": leaves, "n_params": n_params, "bytes": nbytes,
         "ms": sum(leaf["ms"] for leaf in leaves),
         "library_ms": sum(leaf["library_ms"] for leaf in leaves),
         "largest_leaf": max(leaves, key=lambda leaf: leaf["N"]),
         "bound_ms": nbytes / HBM_BYTES_PER_S * 1e3, "bound_by": "bytes"}
    r["bound_share"] = r["bound_ms"] / r["ms"]
    big = r["largest_leaf"]
    cut = "" if n_layers is None else f" ({n_layers} layers)"
    print(f"  {arch}{cut} training leaves: {len(leaves)} launches (K={K} bf16, zero-filled), "
          f"{n_params:,} params, {nbytes / 1e9:.3f} GB: kernel_ms={r['ms']:.5f} in all "
          f"bound_ms={r['bound_ms']:.5f} ({r['bound_share']:.1%} of bound) library_ms="
          f"{r['library_ms']:.5f} (torch.mv, bf16 weights, yardstick only); largest leaf "
          f"{big['shape']} kernel_ms={big['ms']:.5f} library_ms={big['library_ms']:.5f} "
          f"bound_ms={big['N'] * 2 * (K + 1) / HBM_BYTES_PER_S * 1e3:.5f}")
    for leaf in leaves:
        print(f"    {leaf['shape']}: kernel_ms={leaf['ms']:.5f} library_ms={leaf['library_ms']:.5f}")
    del flush
    free_card()
    return r


def bound_of(nbytes, fp32_ops, int_ops=0):
    """Least time on the card (ms) and what sets it: bytes over the HBM rate
    against operations over the peak rate of their type."""
    t_bytes = nbytes / HBM_BYTES_PER_S
    t_ops = fp32_ops / FP32_FLOPS + int_ops / INT32_OPS
    return max(t_bytes, t_ops) * 1e3, ("bytes" if t_bytes >= t_ops else "operations")


def timing_row(tag, fn, plain, library, nbytes, fp32_ops, flush, int_ops=0, kernel_ms=None):
    """Kernel, plain and library times with the bound. ``kernel_ms``: the
    kernel's time, taken already by the caller (``fn`` is then None)."""
    bound, by = bound_of(nbytes, fp32_ops, int_ops)
    r = {"ms": time_ms(fn, flush) if kernel_ms is None else kernel_ms,
         "plain_ms": time_ms(plain, flush),
         "library_ms": time_ms(library, flush), "bound_ms": bound, "bound_by": by,
         "bytes": nbytes}
    r["achieved_GBps"] = nbytes / (r["ms"] * 1e-3) / 1e9
    r["bound_share"] = bound / r["ms"]
    print(f"  {tag}: kernel_ms={r['ms']:.5f} bound_ms={bound:.5f} ({by}; "
          f"{r['bound_share']:.1%} of bound, {r['achieved_GBps']:.0f} GB/s) "
          f"plain_ms={r['plain_ms']:.5f} library_ms={r['library_ms']:.5f}")
    return r


def time_routes(fn_of_route, flush, routes=("general", "stream")):
    """Both routes of a wire kernel in turns (a, b, b, a for ``routes`` (a,
    b)): each route's time the mean of its two medians, and the turns."""
    a, b = routes
    turns = [(r, time_ms(fn_of_route(r), flush)) for r in (a, b, b, a)]
    ms = {r: float(np.mean([t for name, t in turns if name == r])) for r in routes}
    return ms, turns


def time_wire_kernels():
    """The three wire kernels at the main paths' shapes: K=10 clients, the
    2NN's and the CNN's N, chunk 512; q8 codes, q4 words, top-5% pairs. Each
    kernel's two routes are timed in turns; its row's ``ms`` is the route
    ``_route`` picks, which must be the codec kernels' stream route and the
    top-k kernel's fused route, no slower than the other route at the CNN
    shape."""
    from repro_torch.kernels.fedavg_agg import fedavg_aggregate
    from repro_torch.kernels.quantized_agg import (
        _launch,
        _out,
        _route,
        dequantize_ref,
        packed_quantized_aggregate_ref,
        quantized_aggregate_ref,
        stream_plan,
        unpack_ref,
    )
    from repro_torch.kernels import sparse_agg
    from repro_torch.utils.bitpack import words_per_chunk

    flush = flush_buffer()
    K = MAIN_K
    rows = {name: {} for name in WIRE_KERNELS}
    for model, N in MAIN_N.items():
        C = -(-N // CHUNK)
        n_pad = C * CHUNK
        lo, scale = ranges(K, C, seed=7)
        w = normalized(K, seed=7)
        codes = random_codes(K, n_pad, torch.uint8, seed=7)
        wpc = words_per_chunk(CHUNK, 4)
        g = torch.Generator(device="cuda").manual_seed(7)
        words = torch.randint(-2**31, 2**31, (K, C * wpc), generator=g, dtype=torch.int32,
                              device="cuda")
        codecs = (
            ("quantized_aggregate", "q8", codes, 8, 255,
             f"K={K} N_pad={n_pad} C={C}",
             # yardstick: the composition the fusion removes
             lambda: fedavg_aggregate(dequantize_ref(codes, lo, scale, chunk=CHUNK, levels=255), w),
             lambda: quantized_aggregate_ref(codes, lo, scale, w, chunk=CHUNK, levels=255),
             K * n_pad, 0),
            ("packed_quantized_aggregate", "q4", words, 4, 15,
             f"K={K} words={C * wpc} C={C}",
             lambda: fedavg_aggregate(dequantize_ref(
                 unpack_ref(words, bits=4, chunk=CHUNK), lo, scale, chunk=CHUNK, levels=15), w),
             lambda: packed_quantized_aggregate_ref(words, lo, scale, w, bits=4, chunk=CHUNK,
                                                    levels=15),
             K * C * wpc * 4, 2 * K * n_pad),
        )
        for name, codec, payload, bits, levels, shape, library, plain, payload_bytes, int_ops \
                in codecs:
            kw = dict(bits=bits, chunk=CHUNK, levels=levels)
            out = _out(payload, lo, CHUNK)
            route = _route(payload, out, chunk=CHUNK, bits=bits, K=K)
            require(route == "stream", f"{name} {model}: the main shape routes to {route}")
            ms, turns = time_routes(
                lambda r: (lambda: _launch(payload, lo, scale, w, out, route=r, **kw)), flush)
            r = timing_row(f"{name} {codec} {model}: {shape}, routed {route}", None, plain,
                           library, payload_bytes + 2 * K * C * 4 + n_pad * 4 + K * 4,
                           4 * K * n_pad, flush, int_ops=int_ops, kernel_ms=ms[route])
            plan = stream_plan(K, C, chunk=CHUNK, bits=bits)
            r.update(route=route, general_ms=ms["general"], stream_ms=ms["stream"],
                     turns_ms=turns, stream_plan=plan)
            print(f"    turns (general, stream, stream, general): "
                  + ", ".join(f"{t:.5f}" for _, t in turns)
                  + f" ms; stream {ms['stream'] / ms['general']:.3f}x the general time, "
                  f"{ms['stream'] / r['library_ms']:.4f}x the yardstick's; stream block "
                  + " ".join(f"{k}={v}" for k, v in plan.items()))
            if model == "mnist_cnn":
                require(ms["stream"] <= ms["general"],
                        f"{name} {model}: the stream route ({ms['stream']:.5f} ms) is slower "
                        f"than the general one ({ms['general']:.5f} ms)")
            rows[name][model] = r

        k = N * 5 // 100
        idx, vals, w2 = sparse_case(K, N, k, torch.float32, seed=7)
        flat_idx = idx.view(-1)

        def index_add():
            out = torch.zeros(N, device="cuda")
            return out.index_add_(0, flat_idx, (vals * w2[:, None]).view(-1))

        out = torch.empty(N, device="cuda")
        route = sparse_agg._route(idx, vals, out, K=K, k=k)
        require(route == "fused", f"sparse_aggregate {model}: the main shape routes to {route}")
        ms, turns = time_routes(
            lambda r: (lambda: sparse_agg._launch(idx, vals, w2, out, r)), flush,
            routes=("scatter", "fused"))
        r = timing_row(f"sparse_aggregate top{TOPK:g} {model}: K={K} k={k} n={N}, routed {route}",
                       None, lambda: sparse_agg.sparse_aggregate_ref(idx, vals, w2, N),
                       index_add, K * k * 8 + K * 4 + N * 4, 2 * K * k, flush,
                       kernel_ms=ms[route])
        plan = sparse_agg.fused_plan(N)
        r.update(route=route, scatter_ms=ms["scatter"], fused_ms=ms["fused"], turns_ms=turns,
                 fused_plan=plan)
        print(f"    turns (scatter, fused, fused, scatter): "
              + ", ".join(f"{t:.5f}" for _, t in turns)
              + f" ms; fused {ms['fused'] / ms['scatter']:.3f}x the scatter time, "
              f"{ms['fused'] / r['library_ms']:.4f}x the yardstick's; fused grid "
              + " ".join(f"{key}={v}" for key, v in plan.items()))
        if model == "mnist_cnn":
            require(ms["fused"] <= ms["scatter"],
                    f"sparse_aggregate {model}: the fused route ({ms['fused']:.5f} ms) is slower "
                    f"than the scatter one ({ms['scatter']:.5f} ms)")
        rows["sparse_aggregate"][model] = r
    del flush
    return rows


def time_gossip_mix():
    """Both routes at n = 100 nodes on the ring, the small world and the
    full graph, at the 2NN's and the CNN's N, fp32, in turns (gather,
    dense, dense, gather; each route's time the mean of its two medians);
    the row's ``ms`` is the route ``_route`` picks. The bound counts the
    plan's non-zero slots, 2 flops each an element."""
    from repro_torch.kernels.gossip_mix import _launch, _route, gossip_mix_ref, launch_config

    flush = flush_buffer()
    rows = {}
    for plan_name, plan in gossip_plans(N_NODES).items():
        idx = torch.from_numpy(plan.idx).cuda()
        w = torch.from_numpy(plan.weight).cuda()
        W = torch.from_numpy(plan.dense()).cuda()
        nonzero = int(np.count_nonzero(plan.weight))
        for model, N in MAIN_N.items():
            x = torch.randn((N_NODES, N), generator=torch.Generator(device="cuda").manual_seed(7),
                            device="cuda")
            route = _route(x, idx, w)
            turns = [(r, time_ms(lambda: _launch(x, idx, w, r), flush))
                     for r in ("gather", "dense", "dense", "gather")]
            ms = {r: float(np.mean([t for name, t in turns if name == r]))
                  for r in ("gather", "dense")}
            cfg = {r: launch_config(x, idx, x, r) for r in ("gather", "dense")}
            r = timing_row(
                f"gossip_mix {plan_name} {model}: n={N_NODES} N={N} D={plan.max_slots} "
                f"non-zero slots {nonzero}, routed {route}",
                None, lambda: gossip_mix_ref(x, idx, w),
                lambda: torch.matmul(W, x),      # cuBLAS, TF32 off: the reference's oracle
                2 * N_NODES * N * 4 + idx.numel() * 8, 2 * nonzero * N, flush,
                kernel_ms=ms[route])
            r.update(n=N_NODES, N=N, plan=plan_name, max_slots=plan.max_slots,
                     nonzero_slots=nonzero, route=route, gather_ms=ms["gather"],
                     dense_ms=ms["dense"], turns_ms=turns, launch_config=cfg,
                     vs_library=r["ms"] / r["library_ms"])
            print(f"    turns (gather, dense, dense, gather): "
                  + ", ".join(f"{t:.5f}" for _, t in turns)
                  + f" ms; dense {ms['dense'] / ms['gather']:.3f}x the gather time, "
                  f"{ms['dense'] / r['library_ms']:.3f}x torch.matmul's; dense block "
                  + " ".join(f"{k}={v}" for k, v in cfg["dense"].items() if k != "route"))
            rows[f"{plan_name}/{model}"] = r
    del flush
    return rows


# ---------------------------------------------------------------------------
# phases 3-4 for the LM substrate's kernels: flash_attention and ssm_scan
# ---------------------------------------------------------------------------

def close_to_fp32(out, ref32, scale):
    """(ok, err): fp32 outputs within 1e-5 of the inputs' scale (sums over D,
    keys or state in another order, exp2 in place of exp); bf16 outputs
    within one bf16 ulp of the fp32 result (both round it once) plus that.
    err is the max abs error, or for bf16 its share of that allowance."""
    tol = 1e-5 * scale
    if out.dtype == torch.float32:
        err = float((out - ref32).abs().max())
        return err <= tol, err
    share = float(((out.float() - ref32).abs() / (bf16_ulp(ref32) + tol)).max())
    return share <= 1.0, share


def flash_inputs(B, Sq, Sk, H, K, D, dtype, seed):
    g = torch.Generator(device="cuda").manual_seed(seed)
    return tuple(torch.randn(shape, generator=g, device="cuda").to(dtype)
                 for shape in ((B, Sq, H, D), (B, Sk, K, D), (B, Sk, K, D)))


def flash_routed(q, k, v, route, **kw):
    """flash_attention(q, k, v, **kw), required to launch once, through
    ``route``'s kernel ("mma": the tensor-core one; "scalar")."""
    from repro_torch.kernels.flash_attention import flash_attention

    n, tc = flash_attention.launches, flash_attention.tc_launches
    out = flash_attention(q, k, v, **kw)
    require(flash_attention.launches == n + 1
            and flash_attention.tc_launches == tc + (route == "mma"),
            f"flash_attention took the wrong route (want {route}) for {tuple(q.shape)} "
            f"{q.dtype} strides {q.stride()}")
    return out


def check_flash_attention():
    from repro_torch.kernels.flash_attention import (
        flash_attention,
        flash_attention_ref,
        smem_bytes,
    )

    name = "flash_attention"
    # every bf16 case here takes the tensor-core route, every fp32 one the
    # scalar route; S = 1, 37, 130, 2047 are off the 32/64-key and 64-row tiles
    cases = [dict(B=1, S=S, H=H, K=K, D=D, dtype=dtype, mask=mask)
             for dtype in (torch.float32, torch.bfloat16) for D in (64, 128, 192, 256)
             for S in (1, 37, 130, 2047) for H, K in ((32, 8), (8, 1))
             for mask in ("causal", "full", "window")]
    cases += [dict(B=B, S=S, H=H, K=K, D=D, dtype=torch.bfloat16, mask="causal", main=tag)
              for tag, (B, S, H, K, D) in FLASH_SHAPES.items()]
    # cross-attention's: bidirectional, Sq queries over Sk != Sq keys, MHA and
    # GQA, both routes; then SeamlessM4T's two prefill shapes
    cases += [dict(B=1, S=Sq, Sk=Sk, H=H, K=K, D=D, dtype=dtype, mask="full")
              for dtype in (torch.float32, torch.bfloat16) for D in (64, 128)
              for Sq, Sk in ((1, 4096), (37, 130), (130, 37), (2048, 4096))
              for H, K in ((16, 16), (32, 8))]
    cases += [dict(B=B, S=Sq, Sk=Sk, H=H, K=K, D=D, dtype=torch.bfloat16, mask="full", main=tag)
              for tag, (B, Sq, Sk, H, K, D) in FLASH_NONCAUSAL_SHAPES.items()]
    before = flash_attention.launches
    main_err, worst = 0.0, {torch.float32: 0.0, torch.bfloat16: 0.0}
    for i, c in enumerate(cases):
        q, k, v = flash_inputs(c["B"], c["S"], c.get("Sk", c["S"]), c["H"], c["K"], c["D"],
                               c["dtype"], i)
        causal, window = c["mask"] != "full", FLASH_WINDOW if c["mask"] == "window" else 0
        route = "mma" if c["dtype"] == torch.bfloat16 else "scalar"
        out = flash_routed(q, k, v, route, causal=causal, window=window)
        torch.cuda.synchronize()
        require(out.shape == q.shape and out.dtype == q.dtype, f"bad output for {c}")
        ref32 = flash_attention_ref(q.float(), k.float(), v.float(), causal=causal,
                                    window=window)
        ok, err = close_to_fp32(out, ref32, float(v.float().abs().max()))
        worst[c["dtype"]] = max(worst[c["dtype"]], err)
        if "main" in c:
            main_err = max(main_err, float((out.float() - ref32).abs().max()))
        print(f"  B={c['B']} S={c['S']:4d}" + (f"/Sk={c['Sk']:4d}" if "Sk" in c else "")
              + f" H/K={c['H']}/{c['K']} D={c['D']:3d} "
              f"{str(c['dtype'])[6:]:8s} {c['mask']:6s} {route:6s} "
              f"smem={smem_bytes(c['D'], c['dtype'], route)}: "
              + (f"max_abs_err={err:.3e}" if c["dtype"] == torch.float32
                 else f"max_err={err:.3f} of (1 bf16 ulp + tol)")
              + (f" [{c['main']} shape]" if "main" in c else "")
              + (" ok" if ok else " FAIL"))
        if not ok:
            raise AssertionError(f"{name} disagrees with its plain version: {c}")
    # the reference kernel's (BH, S, D) layout, and q, k, v as strided column
    # slices of one fused projection: fp32 on the scalar route, bf16 on the
    # tensor-core route in place (the slices stay on the 16-byte grid)
    q, k, v = (t[:, :, 0] for t in flash_inputs(6, 70, 70, 1, 1, 37, torch.float32, 1))
    out = flash_routed(q, k, v, "scalar", causal=True, window=9)
    ref32 = flash_attention_ref(q[:, :, None], k[:, :, None], v[:, :, None], window=9)[:, :, 0]
    ok, err = close_to_fp32(out, ref32, float(v.abs().max()))
    views = []
    for dtype, route, D in ((torch.float32, "scalar", 64), (torch.bfloat16, "mma", 64),
                            (torch.float32, "scalar", 192), (torch.bfloat16, "mma", 192)):
        qkv = torch.randn((2, 130, 8 * D), device="cuda").to(dtype)
        qs, ks, vs = (qkv[..., a * D:b * D].view(2, 130, b - a, D)
                      for a, b in ((0, 4), (4, 6), (6, 8)))
        out2 = flash_routed(qs, ks, vs, route)
        views.append(close_to_fp32(out2, flash_attention_ref(qs.float(), ks.float(), vs.float()),
                                   float(vs.float().abs().max())))
    # bf16 the tensor-core kernel does not take: D = 96, and q one element
    # into its storage (rows off the 16-byte grid); both on the scalar route
    q, k, v = flash_inputs(1, 130, 130, 4, 2, 96, torch.bfloat16, 2)
    scalar_bf16 = [close_to_fp32(flash_routed(q, k, v, "scalar", causal=causal, window=window),
                                 flash_attention_ref(q.float(), k.float(), v.float(),
                                                     causal=causal, window=window),
                                 float(v.float().abs().max()))
                   for causal, window in ((True, 0), (False, 0), (True, FLASH_WINDOW))]
    q, k, v = flash_inputs(1, 130, 130, 4, 2, 128, torch.bfloat16, 3)
    qu = torch.empty(q.numel() + 1, dtype=q.dtype, device="cuda")[1:].view(q.shape)
    qu.copy_(q)
    require(qu.data_ptr() % 16 != 0, "the unaligned view is aligned")
    scalar_bf16.append(close_to_fp32(flash_routed(qu, k, v, "scalar"),
                                     flash_attention_ref(q.float(), k.float(), v.float()),
                                     float(v.float().abs().max())))
    print(f"  (BH, S, D) layout, D=37, window 9: max_abs_err={err:.3e}; fused q/k/v views at "
          f"D=64 and 192: fp32 max_abs_err={max(views[0][1], views[2][1]):.3e}, bf16 (mma) "
          f"max_err={max(views[1][1], views[3][1]):.3f}; bf16 on the "
          f"scalar route (D=96 x 3 masks, an unaligned q): max_err "
          f"{max(e for _, e in scalar_bf16):.3f} of (1 bf16 ulp + tol)")
    require(ok and all(o for o, _ in views + scalar_bf16),
            f"{name} disagrees with its plain version on layouts or views")
    worst[torch.float32] = max(worst[torch.float32], err, views[0][1], views[2][1])
    worst[torch.bfloat16] = max([worst[torch.bfloat16], views[1][1], views[3][1]]
                                + [e for _, e in scalar_bf16])
    n_extra = 1 + len(views) + len(scalar_bf16)
    require(flash_attention.launches - before == len(cases) + n_extra, "one launch per case")

    q, k, v = flash_inputs(1, 8, 8, 4, 2, 16, torch.float32, 0)
    big = flash_inputs(1, 8, 8, 1, 1, 264, torch.float32, 0)
    n_ref = check_refusals(name, flash_attention, {
        "head_dim 264": lambda: flash_attention(*big),
        "float16": lambda: flash_attention(q.half(), k.half(), v.half()),
        "mixed dtypes": lambda: flash_attention(q, k.bfloat16(), v),
        "3 heads over 2 KV heads": lambda: flash_attention(q[:, :, :3], k, v),
        "k on the CPU": lambda: flash_attention(q, k.cpu(), v),
        "a strided last axis": lambda: flash_attention(
            q, k.transpose(1, 3).contiguous().transpose(1, 3), v),
    })
    print(f"kernels: {name} cuda ok ({len(cases) + n_extra} cases, fp32 max_abs_err "
          f"{worst[torch.float32]:.3e} within 1e-5*max|v|; bf16 max error "
          f"{worst[torch.bfloat16]:.3f} of 1 bf16 ulp + that; {n_ref} refusals)")
    return main_err


def ssm_inputs(B, T, D, N, dtype, seed, h0_scale):
    g = torch.Generator(device="cuda").manual_seed(seed)
    dt = (torch.rand((B, T, D), generator=g, device="cuda") * 0.1 + 1e-3).to(dtype)
    Bm = torch.randn((B, T, N), generator=g, device="cuda").to(dtype)
    Cm = torch.randn((B, T, N), generator=g, device="cuda").to(dtype)
    x = torch.randn((B, T, D), generator=g, device="cuda").to(dtype)
    A = -torch.rand((D, N), generator=g, device="cuda") * 16 - 0.5
    h0 = torch.randn((B, D, N), generator=g, device="cuda") * h0_scale
    return dt, Bm, Cm, x, A, h0


def ssm_lanes_routed(args, lanes=None):
    """ssm_scan(*args), required to launch once with the lanes its launch
    plan picks, or with ``lanes`` forced by the module's private launcher."""
    from repro_torch.kernels.ssm_scan import _launch, launch_plan, ssm_scan

    want = launch_plan(args[0].shape[1]) if lanes is None else lanes
    n, per = ssm_scan.launches, dict(ssm_scan.lane_launches)
    out = ssm_scan(*args) if lanes is None else _launch(*args, lanes)
    per[want] += 1
    require(ssm_scan.launches == n + 1 and ssm_scan.lane_launches == per,
            f"ssm_scan took the wrong launch (want {want} lanes) for {tuple(args[0].shape)}")
    return out


def check_ssm_scan():
    """Every case through the wrapper's launch plan, then with each lane
    count (1, 2, 4 lanes a channel) forced."""
    from repro_torch.kernels.ssm_scan import LANES, ssm_scan, ssm_scan_ref

    name = "ssm_scan"
    # N = 1, 5, 13, 16; T off the 16-step run (8, 24, 37, 100); ragged D
    # (129, 200); T = 1; the Jamba decode and prefill shapes
    shapes = [(1, 8, 4, 2), (2, 24, 8, 4), (1, 16, 16, 8), (2, 100, 200, 16), (3, 37, 129, 5),
              (2, 37, 129, 1), (2, 24, 72, 13), (3, 1, 129, 5), (1, 1, 64, 16),
              (SERVE_BATCH, 1, SSM_D, SSM_N)]
    cases = [dict(shape=s, dtype=dtype, h0=1.0) for dtype in (torch.float32, torch.bfloat16)
             for s in shapes]
    cases.append(dict(shape=(SERVE_BATCH, PROMPT, SSM_D, SSM_N), dtype=torch.float32, h0=0.0,
                      main=True))
    before = ssm_scan.launches
    main_err, worst = 0.0, {torch.float32: 0.0, torch.bfloat16: 0.0}
    n_launched = 0

    def held(tag, args, y32, h32, lanes):
        nonlocal n_launched
        y, h = ssm_lanes_routed(args, lanes)
        torch.cuda.synchronize()
        n_launched += 1
        scale = max(1.0, float(y32.abs().max()), float(h32.abs().max()))
        ok, err = close_to_fp32(y, y32, scale)
        h_err = float((h - h32).abs().max())
        ok = ok and h_err <= 1e-5 * scale and y.dtype == args[3].dtype
        print(f"  {tag} lanes={'plan' if lanes is None else lanes}: "
              + (f"y max_abs_err={err:.3e}" if y.dtype == torch.float32
                 else f"y max_err={err:.3f} of (1 bf16 ulp + tol)")
              + f", h_T max_abs_err={h_err:.3e} (scale {scale:.2f}) {'ok' if ok else 'FAIL'}")
        if not ok:
            raise AssertionError(f"{name} disagrees with its plain version: {tag}, {lanes}")
        return err, max(float((y.float() - y32).abs().max()), h_err)

    for i, c in enumerate(cases):
        args = ssm_inputs(*c["shape"], c["dtype"], i, c["h0"])
        y32, h32 = ssm_scan_ref(*(a.float() for a in args[:4]), args[4], args[5])
        tag = (f"(B, T, D, N)={c['shape']} {str(c['dtype'])[6:]:8s} h0 x{c['h0']}"
               + (" [the Jamba prefill shape]" if c.get("main") else ""))
        for lanes in (None, *LANES):
            err, abs_err = held(tag, args, y32, h32, lanes)
            worst[c["dtype"]] = max(worst[c["dtype"]], err)
            if c.get("main") and lanes is None:
                main_err = abs_err
    # B and C as column slices of one projection, as mamba_apply makes them
    # in fp32; and a time slice of a longer scan (ops.mamba_ssm_scan's chunks)
    dt, Bm, Cm, x, A, h0 = ssm_inputs(2, 50, 96, 16, torch.float32, 99, 1.0)
    dbc = torch.cat([torch.randn((2, 50, 6), device="cuda"), Bm, Cm], dim=-1)
    y32, h32 = ssm_scan_ref(dt, Bm, Cm, x, A, h0)
    for lanes in (None, *LANES):
        err, _ = held("strided B/C views (2, 50, 96, 16) float32",
                      (dt, dbc[..., 6:22], dbc[..., 22:], x, A, h0), y32, h32, lanes)
        worst[torch.float32] = max(worst[torch.float32], err)
    y32, h32 = ssm_scan_ref(dt[:, 13:40], Bm[:, 13:40], Cm[:, 13:40], x[:, 13:40], A, h0)
    for lanes in (None, *LANES):
        err, _ = held("time slice [13:40] of the views",
                      (dt[:, 13:40], dbc[:, 13:40, 6:22], dbc[:, 13:40, 22:], x[:, 13:40], A, h0),
                      y32, h32, lanes)
        worst[torch.float32] = max(worst[torch.float32], err)
    require(ssm_scan.launches - before == n_launched, "one launch per case and lane count")

    dt, Bm, Cm, x, A, h0 = ssm_inputs(1, 4, 8, 4, torch.float32, 0, 0.0)
    big = ssm_inputs(1, 4, 8, 17, torch.float32, 0, 0.0)
    n_ref = check_refusals(name, ssm_scan, {
        "d_state 17": lambda: ssm_scan(*big),
        "bf16 x with fp32 dt": lambda: ssm_scan(dt, Bm, Cm, x.bfloat16(), A, h0),
        "bf16 A": lambda: ssm_scan(dt, Bm, Cm, x, A.bfloat16(), h0),
        "A of another shape": lambda: ssm_scan(dt, Bm, Cm, x, A[:4], h0),
        "A on the CPU": lambda: ssm_scan(dt, Bm, Cm, x, A.cpu(), h0),
        "a strided last axis": lambda: ssm_scan(
            dt.transpose(1, 2).contiguous().transpose(1, 2), Bm, Cm, x, A, h0),
    })
    print(f"kernels: {name} cuda ok ({len(cases) + 2} cases, {n_launched} launches; fp32 "
          f"max_abs_err {worst[torch.float32]:.3e} within 1e-5*scale; bf16 max error "
          f"{worst[torch.bfloat16]:.3f} of 1 bf16 ulp + that; {n_ref} refusals)")
    return main_err


def lm_row(tag, fn, plain, library, nbytes, flops, flush, *, sfu_ops=0, tensor_core=False,
           plain_iters=5, kernel_ms=None):
    """Kernel, plain and library times with the bound: bytes over the HBM
    rate against the operations over the rate of their unit (bf16 tensor
    cores, fp32 FMA pipes, special-function units; pipes run at once, so
    the slowest sets the time). ``kernel_ms``: the kernel's time, taken
    already by the caller."""
    t_bytes = nbytes / HBM_BYTES_PER_S
    t_ops = max(flops / (BF16_FLOPS if tensor_core else FP32_FLOPS), sfu_ops / SFU_OPS)
    r = {"ms": time_ms(fn, flush) if kernel_ms is None else kernel_ms,
         "plain_ms": time_ms(plain, flush, iters=plain_iters, warmup=1),
         "library_ms": None if library is None else time_ms(library, flush),
         "bound_ms": max(t_bytes, t_ops) * 1e3,
         "bound_by": "bytes" if t_bytes >= t_ops else "operations",
         "bytes": nbytes, "flops": flops, "sfu_ops": sfu_ops}
    r["bound_share"] = r["bound_ms"] / r["ms"]
    lib = "none" if library is None else f"{r['library_ms']:.5f}"
    print(f"  {tag}: kernel_ms={r['ms']:.5f} bound_ms={r['bound_ms']:.5f} ({r['bound_by']}; "
          f"{r['bound_share']:.1%} of bound) plain_ms={r['plain_ms']:.5f} library_ms={lib}")
    return r


FLASH_MIN_SPEEDUP = 5.0   # the tensor-core route against the scalar one, same run


def time_flash_attention():
    """At the prefill shapes (MLA's at D = 192 among them) and Gemma-2B's
    training shape in bf16, causal, and SeamlessM4T's encoder and
    cross-attention shapes, non-causal (Sq != Sk for cross-attention): the
    work is the unmasked (query, key) pairs, 4 * D flops each on the tensor
    cores' rate (at D = 192 a third of the P V product is MLA's zero padding
    of V, counted as the kernel does it). The tensor-core route (the one
    ``flash_attention`` takes here) and the scalar route (through the
    module's private launcher) in turns: scalar, tensor cores, tensor cores,
    scalar; each route's time is the mean of its two medians (of
    FLASH_SCALAR_ITERS launches on the scalar route where a shape sets it)."""
    from repro_torch.kernels.flash_attention import _launch, flash_attention, flash_attention_ref

    sdpa = torch.nn.functional.scaled_dot_product_attention
    flush = flush_buffer()
    rows = {}
    shapes = [(tag, B, S, S, H, K, D, True) for tag, (B, S, H, K, D) in FLASH_SHAPES.items()]
    shapes += [(tag, *shape, False) for tag, shape in FLASH_NONCAUSAL_SHAPES.items()]
    for tag, B, S, Sk, H, K, D, causal in shapes:
        q, k, v = flash_inputs(B, S, Sk, H, K, D, torch.bfloat16, 7)
        qt, kt, vt = (t.transpose(1, 2) for t in (q, k, v))
        pairs = B * H * S * (S + 1) // 2 if causal else B * H * S * Sk
        flops = 4 * D * pairs
        flash_routed(q, k, v, "mma", causal=causal)
        routes = {"scalar": lambda: _launch(q, k, v, causal, 0, False, "scalar"),
                  "mma": lambda: flash_attention(q, k, v, causal=causal)}
        iters = {"scalar": FLASH_SCALAR_ITERS.get(tag, FLASH_SCALAR_DEFAULT_ITERS), "mma": 200}
        turns = [(name, time_ms(routes[name], flush, iters=iters[name],
                                warmup=min(20, iters[name])))
                 for name in ("scalar", "mma", "mma", "scalar")]
        tc_ms = float(np.mean([t for name, t in turns if name == "mma"]))
        scalar_ms = float(np.mean([t for name, t in turns if name == "scalar"]))
        mask = "causal" if causal else "non-causal"
        rows[tag] = lm_row(
            f"flash_attention {tag}: B={B} S={S}" + (f" Sk={Sk}" if Sk != S else "")
            + f" H/K={H}/{K} D={D} bf16 {mask}, tensor-core route",
            None, lambda: flash_attention_ref(q, k, v, causal=causal),
            lambda: sdpa(qt, kt, vt, is_causal=causal, enable_gqa=True),
            (2 * B * S * H * D + 2 * B * Sk * K * D) * 2, flops, flush,
            tensor_core=True, kernel_ms=tc_ms, plain_iters=2)
        rows[tag].update(B=B, S=S, Sk=Sk, H=H, K=K, D=D, dtype="bfloat16", causal=causal,
                         route="mma",
                         scalar_ms=scalar_ms, turns_ms=turns, speedup=scalar_ms / tc_ms,
                         TFLOPs=flops / tc_ms / 1e9, scalar_TFLOPs=flops / scalar_ms / 1e9,
                         vs_library=tc_ms / rows[tag]["library_ms"])
        r = rows[tag]
        print(f"    turns (scalar, mma, mma, scalar): "
              + ", ".join(f"{t:.5f}" for _, t in turns)
              + f" ms; tensor cores {r['TFLOPs']:.1f} TFLOP/s counted, scalar "
              f"{r['scalar_TFLOPs']:.1f}; {r['speedup']:.2f}x faster than the scalar route, "
              f"{r['vs_library']:.2f}x SDPA's time")
        require(r["speedup"] >= FLASH_MIN_SPEEDUP,
                f"flash_attention {tag}: the tensor-core route is only {r['speedup']:.2f}x "
                f"faster than the scalar route (want >= {FLASH_MIN_SPEEDUP})")
    rows.update(time_flash_training(flush))
    del flush
    return rows


def time_flash_training(flush):
    """The forward ``ops.FlashAttention`` runs at phase 30's SeamlessM4T
    shapes and phase 31's: ``flash_attention(return_lse=True)`` on the
    tensor-core route, non-causal at Sq = Sk = 2048 (the encoder's and
    cross-attention's one shape, timed once) and causal (the decoder;
    DeepSeek-V2-Lite's MLA at D = 192, a third of its P V on V's zero
    padding, counted as the kernel does it; Qwen2-VL's GQA 28/4 at D = 128),
    against the plain version with its lse and SDPA (which returns no lse).
    Bound: the unmasked pairs' 4 D flops on the tensor cores against q, k, v
    read and the output and lse written once."""
    from repro_torch.kernels.flash_attention import flash_attention, flash_attention_ref

    sdpa = torch.nn.functional.scaled_dot_product_attention
    rows = {}
    for tag in ("seamless train encoder", "seamless train decoder", "deepseek-v2-lite train",
                "qwen2-vl train"):
        B, S, Sk, H, K, D, causal = FLASH_TRAIN_SHAPES[tag]
        q, k, v = flash_inputs(B, S, Sk, H, K, D, torch.bfloat16, 9)
        qt, kt, vt = (t.transpose(1, 2) for t in (q, k, v))
        pairs = B * H * S * (S + 1) // 2 if causal else B * H * S * Sk
        flash_routed(q, k, v, "mma", causal=causal, return_lse=True)
        name = tag + (" (and cross)" if not causal else "")
        rows[name] = lm_row(
            f"flash_attention {name}: B={B} S={S} Sk={Sk} H/K={H}/{K} D={D} bf16 "
            f"{'causal' if causal else 'non-causal'}, with lse, tensor-core route",
            lambda: flash_attention(q, k, v, causal=causal, return_lse=True),
            lambda: flash_attention_ref(q, k, v, causal=causal, return_lse=True),
            lambda: sdpa(qt, kt, vt, is_causal=causal, enable_gqa=True),
            (2 * B * S * H * D + 2 * B * Sk * K * D)
            * 2 + B * S * H * 4, 4 * D * pairs, flush, tensor_core=True, plain_iters=2)
        r = rows[name]
        r.update(B=B, S=S, Sk=Sk, H=H, K=K, D=D, dtype="bfloat16", causal=causal, route="mma",
                 lse=True, TFLOPs=4 * D * pairs / r["ms"] / 1e9,
                 vs_library=r["ms"] / r["library_ms"])
        print(f"    {r['TFLOPs']:.1f} TFLOP/s counted; {r['vs_library']:.2f}x SDPA's time")
    return rows


SSM_PLAN_SLACK = 1.05   # the launch plan's lanes within 5% of the fastest, same run


def time_ssm_scan():
    """At the Jamba prefill shape (T = 2048) and its decode step (T = 1), fp32
    as mamba_apply passes it: one exp2 per (b, t, d, n) on the
    special-function units, four fp32 operations beside it and one more per
    (b, t, d). Every lane count in turns, forwards then backwards; each
    one's time the mean of its two medians. The launch plan's lanes must
    be within SSM_PLAN_SLACK of the fastest."""
    from repro_torch.kernels.ssm_scan import LANES, _launch, launch_plan, ssm_scan_ref

    flush = flush_buffer()
    rows = {}
    for tag, T in (("jamba/prefill", PROMPT), ("jamba/decode", 1)):
        B, D, N = SERVE_BATCH, SSM_D, SSM_N
        args = ssm_inputs(B, T, D, N, torch.float32, 7, 1.0 if T == 1 else 0.0)
        order = LANES
        turns = [(lanes, time_ms(lambda: _launch(*args, lanes), flush))
                 for lanes in order + order[::-1]]
        ms = {lanes: float(np.mean([t for k, t in turns if k == lanes])) for lanes in order}
        plan = launch_plan(T)
        rows[tag] = lm_row(
            f"ssm_scan {tag}: B={B} T={T} D={D} N={N} fp32, {plan} lanes a channel (the plan)",
            None, lambda: ssm_scan_ref(*args), None,
            (3 * B * T * D + 2 * B * T * N + D * N + 2 * B * D * N) * 4,
            B * T * D * (4 * N + 1), flush, sfu_ops=B * T * D * N,
            plain_iters=3 if T > 1 else 20, kernel_ms=ms[plan])
        rows[tag].update(B=B, T=T, D=D, N=N, dtype="float32", lanes=plan, lanes_ms=ms,
                         turns_ms=turns)
        print(f"    turns (lanes " + ", ".join(str(k) for k, _ in turns) + "): "
              + ", ".join(f"{t:.5f}" for _, t in turns) + " ms; by lanes "
              + ", ".join(f"{k}: {v:.5f}" for k, v in ms.items()) + " ms")
        fastest = min(ms[k] for k in LANES)
        require(ms[plan] <= SSM_PLAN_SLACK * fastest,
                f"ssm_scan {tag}: the plan's {plan} lanes take {ms[plan]:.5f} ms, the fastest "
                f"lane count {fastest:.5f} ms")
    del flush
    return rows


def ssm_bwd_inputs(B, T, D, N, seed, views=False):
    """The scan's inputs in fp32 with a nonzero h0, and the cotangents gy
    and g_hT; with ``views`` B and C are column slices of one projection, as
    ``mamba_apply`` passes them in fp32."""
    dt, Bm, Cm, x, A, h0 = ssm_inputs(B, T, D, N, torch.float32, seed, 1.0)
    g = torch.Generator(device="cuda").manual_seed(seed + 1)
    gy = torch.randn((B, T, D), generator=g, device="cuda")
    gh = torch.randn((B, D, N), generator=g, device="cuda")
    if views:
        dbc = torch.cat([torch.randn((B, T, 6), device="cuda"), Bm, Cm], dim=-1)
        Bm, Cm = dbc[..., 6:6 + N], dbc[..., 6 + N:]
    return (dt, Bm, Cm, x, A, h0), gy, gh


SSM_GRADS = ("g_dt", "g_Bm", "g_Cm", "g_x", "g_A", "g_h0")


def ssm_bwd_errors(got, want):
    """{gradient: max |got - want| / max(1, max |want|)} over the ones given."""
    return {n: float((g - w).abs().max()) / max(1.0, float(w.abs().max()))
            for n, g, w in zip(SSM_GRADS, got, want) if w is not None}


def check_ssm_scan_bwd():
    """The scan's backward: the forward's checkpoints (kernel against plain,
    and y, h_T unchanged by writing them), then ``ssm_scan_bwd`` from them
    against ``ssm_scan_bwd_ref`` over B in {1, 2}, T in {1, 37, 2048} (37
    off the 16-step run), D in {24, 8192}, N in {4, 16}, with a nonzero h0
    and g_hT; on B/C views with gradients asked for in part; the composed
    ``SSMScan`` against autograd through ``ssm_scan_ref``; the refusals."""
    from repro_torch.kernels import ops
    from repro_torch.kernels.ssm_scan import (
        ssm_scan,
        ssm_scan_bwd,
        ssm_scan_bwd_ref,
        ssm_scan_ref,
    )

    name = "ssm_scan_bwd"
    cases = [dict(shape=(B, T, D, N)) for B in (1, 2) for T in (1, 37, 2048) for D in (24, 8192)
             for N in (4, 16)]
    cases += [dict(shape=(2, 50, 96, 16), views=True, needs=needs)
              for needs in ((True,) * 6, (True, True, True, True, True, False),
                            (False, False, True, False, True, False))]
    before = ssm_scan_bwd.launches
    worst, main_err = 0.0, 0.0
    for i, c in enumerate(cases):
        args, gy, gh = ssm_bwd_inputs(*c["shape"], seed=100 + i, views=c.get("views", False))
        needs = c.get("needs", (True,) * 6)
        g_hT = gh if needs[5] else None
        y, h, ck = ssm_scan(*args, checkpoints=True)
        y0, h0 = ssm_scan(*args)
        _, _, ck32 = ssm_scan_ref(*args, checkpoints=True)
        ck_err = float((ck - ck32).abs().max()) / max(1.0, float(ck32.abs().max()))
        got = ssm_scan_bwd(*args, gy, g_hT, checkpoints=ck, needs=needs)
        torch.cuda.synchronize()
        want = ssm_scan_bwd_ref(*args, gy, g_hT, needs)
        errs = ssm_bwd_errors(got, want)
        asked = all((g is None) == (w is None) for g, w in zip(got, want))
        ok = (max(errs.values()) <= SSM_BWD_RTOL and ck_err <= SSM_BWD_RTOL and asked
              and torch.equal(y, y0) and torch.equal(h, h0))
        tag = (f"(B, T, D, N)={c['shape']}" + (" B/C views" if c.get("views") else "")
               + ("" if all(needs) else f" needs {''.join('1' if n else '0' for n in needs)}"))
        print(f"  {tag}: checkpoints {ck_err:.2e}; " + " ".join(
            f"{k}={e:.2e}" for k, e in errs.items()) + f" (rtol {SSM_BWD_RTOL:g} of max(1, "
            f"max|ref|)) {'ok' if ok else 'FAIL'}")
        if not ok:
            raise AssertionError(f"{name} disagrees with its plain version: {tag}")
        worst = max(worst, *errs.values())
        if c["shape"] == (SSM_TRAIN_B, PROMPT, SSM_D, SSM_N):
            main_err = max(float((g - w).abs().max()) for g, w in zip(got, want))
    require(ssm_scan_bwd.launches - before == len(cases), "one backward launch a case")

    # the composed SSMScan against autograd through the plain scan, B and C
    # sliced from one projection that requires grad, as in mamba_apply
    (dt, Bm, Cm, x, A, h0), gy, gh = ssm_bwd_inputs(2, 130, 96, 16, seed=7)
    dbc = torch.cat([torch.randn((2, 130, 6), device="cuda"), Bm, Cm], dim=-1)

    def through(scan):
        leaves = [t.detach().clone().requires_grad_() for t in (dt, dbc, x, A, h0)]
        d, p, xx, a, h = leaves
        y, h_T = scan(d, p[..., 6:22], p[..., 22:], xx, a, h)
        torch.autograd.backward([y, h_T], [gy, gh])
        return [y.detach(), h_T.detach()] + [t.grad for t in leaves]

    n = (counters()["ssm_scan"].launches, ssm_scan_bwd.launches)
    got = through(ops.mamba_ssm_scan_train)
    torch.cuda.synchronize()
    require((counters()["ssm_scan"].launches, ssm_scan_bwd.launches) == (n[0] + 1, n[1] + 1),
            "SSMScan: one forward and one backward launch")
    want = through(ssm_scan_ref)
    errs = {k: float((g - w).abs().max()) / max(1.0, float(w.abs().max()))
            for k, g, w in zip(("y", "h_T", "g_dt", "g_dbc", "g_x", "g_A", "g_h0"), got, want)}
    ok = max(errs.values()) <= SSM_BWD_RTOL
    print("  SSMScan (2, 130, 96, 16), B and C sliced from a projection, against autograd "
          "through ssm_scan_ref: " + " ".join(f"{k}={e:.2e}" for k, e in errs.items())
          + f" {'ok' if ok else 'FAIL'}")
    require(ok, "SSMScan's gradients disagree with autograd through the plain scan")

    args, gy, gh = ssm_bwd_inputs(1, 20, 8, 4, seed=0)
    _, _, ck = ssm_scan(*args, checkpoints=True)
    dt, Bm, Cm, x, A, h0 = args
    big, gyb, ghb = ssm_bwd_inputs(1, 20, 8, 17, seed=0)
    n_ref = check_refusals(name, ssm_scan_bwd, {
        "no checkpoints": lambda: ssm_scan_bwd(*args, gy, gh),
        "checkpoints of another shape": lambda: ssm_scan_bwd(*args, gy, gh,
                                                             checkpoints=ck[:, :1]),
        "bf16 x": lambda: ssm_scan_bwd(dt, Bm, Cm, x.bfloat16(), A, h0, gy, gh, checkpoints=ck),
        "bf16 gy": lambda: ssm_scan_bwd(*args, gy.bfloat16(), gh, checkpoints=ck),
        "d_state 17": lambda: ssm_scan_bwd(*big, gyb, ghb,
                                           checkpoints=torch.zeros((1, 2, 8, 17), device="cuda")),
        "gy of another shape": lambda: ssm_scan_bwd(*args, gy[:, :4], gh, checkpoints=ck),
        "gy on the CPU": lambda: ssm_scan_bwd(*args, gy.cpu(), gh, checkpoints=ck),
        "a strided last axis": lambda: ssm_scan_bwd(
            *args, gy.transpose(1, 2).contiguous().transpose(1, 2), gh, checkpoints=ck),
    })
    print(f"kernels: {name} cuda ok ({len(cases)} cases and the composed SSMScan; max error "
          f"{worst:.2e} of max(1, max|ref|), rtol {SSM_BWD_RTOL:g}; {n_ref} refusals)")
    return main_err


def time_ssm_scan_bwd():
    """At the training shape (B = 2, T = 2048, D = 8192, N = 16, fp32): the
    backward from the forward's checkpoints, its plain version, and the
    bound: dt, x, gy, B, C, A, g_hT and the checkpoints read once, the six
    gradients written once, against the B T D N exponentials the function
    needs (one a state and step; the kernel takes two) and ~12 fp32
    operations beside each. No one PyTorch call computes it. Beside it the
    forward with and without its checkpoints, in turns."""
    from repro_torch.kernels.ssm_scan import (
        _launch,
        launch_plan,
        n_checkpoints,
        ssm_scan,
        ssm_scan_bwd,
        ssm_scan_bwd_ref,
    )

    flush = flush_buffer()
    B, T, D, N = SSM_TRAIN_B, PROMPT, SSM_D, SSM_N
    args, gy, gh = ssm_bwd_inputs(B, T, D, N, seed=9)
    _, _, ck = ssm_scan(*args, checkpoints=True)
    S = n_checkpoints(T)
    nbytes = (3 * B * T * D + 2 * B * T * N + D * N + B * D * N + B * S * D * N   # read
              + 2 * B * T * D + 2 * B * T * N + D * N + B * D * N) * 4          # written
    row = lm_row(f"ssm_scan_bwd jamba/train: B={B} T={T} D={D} N={N} fp32, from "
                 f"{S} checkpoints a channel",
                 lambda: ssm_scan_bwd(*args, gy, gh, checkpoints=ck),
                 lambda: ssm_scan_bwd_ref(*args, gy, gh), None, nbytes,
                 12 * B * T * D * N, flush, sfu_ops=B * T * D * N, plain_iters=1)
    lanes = launch_plan(T)
    ck_out = torch.empty_like(ck)
    turns = [(k, time_ms((lambda: _launch(*args, lanes, ck_out)) if k == "checkpoints" else
                         (lambda: _launch(*args, lanes)), flush))
             for k in ("plain", "checkpoints", "checkpoints", "plain")]
    fwd = {k: float(np.mean([t for n, t in turns if n == k])) for k in ("plain", "checkpoints")}
    print(f"    the forward at this shape, {lanes} lanes, in turns (without, with, with, "
          f"without the checkpoints): " + ", ".join(f"{t:.5f}" for _, t in turns)
          + f" ms; the backward {row['ms'] / fwd['checkpoints']:.2f}x the forward's time")
    row.update(B=B, T=T, D=D, N=N, dtype="float32", checkpoints=S, forward_ms=fwd,
               forward_turns_ms=turns)
    del flush
    return {"jamba/train": row}


# ---------------------------------------------------------------------------
# phases 3-4 for the training path: fused_cross_entropy, the flash kernel's
# lse, and the grad guard of every kernel
# ---------------------------------------------------------------------------

def ce_inputs(T, d, V, dtype, layout, seed, same_label=False):
    """hidden ~ N(0, 1), a head ~ N(0, 1/d) so logits are O(1), labels with
    0 and V - 1 among them (or one label for every token). ``layout`` is
    "tied" (the transposed view of a (V, d) table), "contiguous" (a (d, V)
    tensor), "sliced" (the first V columns of a (d, V') tensor, V' a
    multiple of 8 above V: a (d, V) view with contiguous rows that the
    tensor-core route takes at any V) or "staged" (a contiguous (d, V) head
    as ``ops.FusedCrossEntropy`` passes it on: ``ops.tensor_core_head``'s
    copy, V' = V rounded up to 8, where V is no multiple of 8)."""
    from repro_torch.kernels.ops import tensor_core_head

    g = torch.Generator(device="cuda").manual_seed(seed)
    hidden = torch.randn((T, d), generator=g, device="cuda").to(dtype)
    if layout == "tied":
        head = (torch.randn((V, d), generator=g, device="cuda") / math.sqrt(d)).to(dtype).T
    else:
        pitch = V if layout in ("contiguous", "staged") else -(-V // 8) * 8 + 8
        head = (torch.randn((d, pitch), generator=g, device="cuda") / math.sqrt(d)).to(dtype)
        head = head[:, :V]
        if layout == "staged":
            head = tensor_core_head(hidden, head)
    labels = torch.randint(0, V, (T,), generator=g, device="cuda", dtype=torch.int32)
    labels[0] = 0
    labels[-1] = V - 1
    if same_label:
        labels.fill_(V // 2)
    return hidden, head, labels


def ce_routed(hidden, head, labels, route):
    """fused_cross_entropy(hidden, head, labels), required to launch once,
    through ``route``'s kernels ("mma": the tensor-core one, which the
    wrapper must choose; "scalar": the wrapper's choice where it routes the
    inputs there, else forced through the module's private launcher)."""
    from repro_torch.kernels.ce_loss import _launch, _route, fused_cross_entropy

    n, tc = fused_cross_entropy.launches, fused_cross_entropy.tc_launches
    if route == "mma" or _route(hidden, head) == "scalar":
        out = fused_cross_entropy(hidden, head, labels)
    else:
        out = _launch(hidden, head, labels, "scalar")
    require(fused_cross_entropy.launches == n + 1
            and fused_cross_entropy.tc_launches == tc + (route == "mma"),
            f"fused_cross_entropy took the wrong route (want {route}) for hidden "
            f"{tuple(hidden.shape)} {hidden.dtype}, head strides {head.stride()}")
    return out


def check_fused_cross_entropy():
    """The kernels against their plain version on the same inputs widened
    to fp32 (bf16 products are exact in fp32, so both compute one function):
    loss and lse within 1e-5 * max(1, |lse|) (fp32 sums of d products and of
    V exponentials in other orders). Every fp32 case takes the scalar route;
    every bf16 case runs on the scalar route and, where ``_route`` sends it
    there, on the tensor-core route (the tied view and the sliced (d, V)
    view always; a contiguous (d, V) head where V is a multiple of 8)."""
    from repro_torch.kernels.ce_loss import (
        _launch,
        _route,
        fused_cross_entropy,
        fused_cross_entropy_ref,
    )

    name = "fused_cross_entropy"
    cases = [dict(T=T, d=d, V=V, dtype=dtype, layout=layout)
             for dtype in (torch.float32, torch.bfloat16) for layout in ("contiguous", "tied")
             for T in (1, 37, 4096) for V in (1, 1000, 2049, 256_000) for d in (64, 2048)
             if not (T == 4096 and V == 256_000 and d == 64)]
    cases += [dict(T=T, d=2048, V=V, dtype=torch.bfloat16, layout="sliced")
              for T in (1, 37, 4096) for V in (1, 1000, 2049, 256_000)]
    cases.append(dict(T=37, d=64, V=1000, dtype=torch.float32, layout="contiguous",
                      same_label=True))
    # phase 30's two heads at the training step's T, as train_loss passes them
    cases += [dict(T=T, d=d, V=V, dtype=torch.bfloat16, layout=layout, arch=arch)
              for arch, (T, d, V, layout) in CE_ARCH_SHAPES.items()]
    before = fused_cross_entropy.launches
    main_err, worst = 0.0, {"scalar": 0.0, "mma": 0.0}
    n_runs, scalar_only = 0, []
    for i, c in enumerate(cases):
        hidden, head, labels = ce_inputs(c["T"], c["d"], c["V"], c["dtype"], c["layout"], i,
                                         c.get("same_label", False))
        ref_loss, ref_lse = fused_cross_entropy_ref(hidden.float(), head.float(), labels)
        tol = 1e-5 * max(1.0, float(ref_lse.abs().max()))
        routes = ["scalar"] + (["mma"] if _route(hidden, head) == "mma" else [])
        if c["dtype"] == torch.bfloat16 and routes == ["scalar"]:
            scalar_only.append((c["layout"], c["V"]))
        require(c["dtype"] == torch.float32 or c["layout"] != "tied" or "mma" in routes,
                f"a bf16 tied head does not take the tensor-core route: {c}")
        require("arch" not in c or "mma" in routes,
                f"{c.get('arch')}'s training head does not take the tensor-core route: {c}")
        for route in routes:
            loss, lse = ce_routed(hidden, head, labels, route)
            torch.cuda.synchronize()
            n_runs += 1
            err = max(float((loss - ref_loss).abs().max()), float((lse - ref_lse).abs().max()))
            ok = (err <= tol and loss.dtype == lse.dtype == torch.float32
                  and bool(torch.isfinite(loss).all()))
            worst[route] = max(worst[route], err / tol)
            main = ((c["T"], c["d"], c["V"]) == CE_SHAPE and c["dtype"] == torch.bfloat16
                    and c["layout"] == "tied" and route == "mma")
            if main:
                main_err = err
            if (main or not ok or c["T"] == 4096 and c["V"] == 256_000 or c.get("same_label")
                    or "arch" in c):
                print(f"  T={c['T']:4d} d={c['d']:4d} V={c['V']:6d} {str(c['dtype'])[6:]:8s} "
                      f"{c['layout']:10s} {route:6s}"
                      f"{' one label' if c.get('same_label') else ''}: max_abs_err={err:.3e} "
                      f"(tol {tol:.2e}){' [the training shape]' if main else ''}"
                      + (f" [{c['arch']}'s training step]" if "arch" in c else "")
                      + (" ok" if ok else " FAIL"))
            if not ok:
                raise AssertionError(f"{name} {route} disagrees with its plain version: {c}")
    require(fused_cross_entropy.launches - before == n_runs, "one launch per run")

    hidden, head, labels = ce_inputs(8, 16, 40, torch.float32, "tied", 0)
    big_h = torch.empty((1, 16), device="cuda").expand(2**31, 16)
    big_l = torch.zeros(1, dtype=torch.int32, device="cuda").expand(2**31)
    hb, wb = hidden.bfloat16(), head.bfloat16()
    n_ref = check_refusals(name, fused_cross_entropy, {
        "mixed dtypes": lambda: fused_cross_entropy(hidden.bfloat16(), head, labels),
        "float16": lambda: fused_cross_entropy(hidden.half(), head.half(), labels),
        "int64 labels": lambda: fused_cross_entropy(hidden, head, labels.long()),
        "labels on the CPU": lambda: fused_cross_entropy(hidden, head, labels.cpu()),
        "the meta device": lambda: fused_cross_entropy(hidden.to("meta"), head.to("meta"),
                                                       labels.to("meta")),
        "2^31 tokens (beyond the grid's token index)": lambda: fused_cross_entropy(
            big_h, head, big_l),
        "a strided last axis": lambda: fused_cross_entropy(hidden.T.contiguous().T, head,
                                                           labels),
        "hidden that requires grad": lambda: fused_cross_entropy(
            hidden.clone().requires_grad_(), head, labels),
        "the tensor-core route forced on fp32": lambda: _launch(hidden, head, labels, "mma"),
        "the tensor-core route forced on a one-element offset": lambda: _launch(
            torch.empty(8 * 16 + 1, dtype=torch.bfloat16, device="cuda")[1:].view(8, 16), wb,
            labels, "mma"),
        "an unknown route": lambda: _launch(hb, wb, labels, "wgmma"),
    })
    print(f"kernels: {name} cuda ok ({len(cases)} cases, {n_runs} runs; max error of "
          f"1e-5*max(1, |lse|): scalar route {worst['scalar']:.3f}, tensor-core route "
          f"{worst['mma']:.3f}; bf16 cases on the scalar route only (head layout, V): "
          f"{sorted(set(scalar_only))}; {n_ref} refusals)")
    return main_err


def ce_probs_tol(p32, p_one, g, lse, dtype):
    """ce_probs' allowance at each element against the fp32 value ``p32``
    (not rounded): rounding to ``dtype`` (one bf16 ulp, as both sides round
    once; an fp32 epsilon of |p32|), plus |g| (1e-6 + p * 1e-5 *
    max(1, |lse|)), with p = softmax = ``p_one`` + the one-hot: 1e-6 for
    the exp, and the forward's 1e-5 * max(1, |lse|) on the logits (fp32 sums
    of d products in another order) carried into p, which is where p is
    near 1 (V = 1) the whole of g (p - 1)."""
    logit_tol = 1e-5 * max(1.0, float(lse.abs().max()))
    rnd = (bf16_ulp(p32) if dtype == torch.bfloat16
           else p32.abs() * torch.finfo(torch.float32).eps)
    return rnd + g.abs()[:, None] * (1e-6 + p_one * logit_tol)


def probs_routed(hidden, head, labels, lse, g, route):
    """ce_probs(hidden, head, labels, lse, g), required to launch once,
    through ``route``'s kernel, as :func:`ce_routed` does for the
    forward."""
    from repro_torch.kernels.ce_loss import _launch_probs, _route, ce_probs

    n, tc = ce_probs.launches, ce_probs.tc_launches
    if route == "mma" or _route(hidden, head) == "scalar":
        out = ce_probs(hidden, head, labels, lse, g)
    else:
        out = _launch_probs(hidden, head, labels, lse, g, "scalar")
    require(ce_probs.launches == n + 1 and ce_probs.tc_launches == tc + (route == "mma"),
            f"ce_probs took the wrong route (want {route}) for hidden "
            f"{tuple(hidden.shape)} {hidden.dtype}, head strides {head.stride()}")
    return out


def check_ce_probs():
    """ce_probs (ce_probs_mma_kernel and ce_probs_kernel) against
    ce_probs_ref on the same inputs widened to fp32, from the plain
    forward's lse, with per-token upstream gradients g in [0.5, 1.5) / T
    and, beside the labels 0 and V - 1, the labels -1 and V (no column): at
    the training step's chunk (1,024 tokens of the tied 256,000-word head,
    d = 2048) and at ragged T and V on the tied and sliced layouts; within
    :func:`ce_probs_tol`. Every bf16 case runs on both routes, every fp32
    case (and bf16 at d = 12) on the scalar route, the wrapper's choice for
    them."""
    from repro_torch.kernels.ce_loss import (
        _launch_probs,
        _route,
        ce_probs,
        ce_probs_ref,
        fused_cross_entropy_ref,
    )

    cases = [dict(T=CE_CHUNK_TOKENS, d=CE_SHAPE[1], V=CE_SHAPE[2], layout="tied",
                  dtype=torch.bfloat16, main=True)]
    cases += [dict(T=T, d=d, V=V, layout=layout, dtype=dtype)
              for dtype in (torch.bfloat16, torch.float32)
              for layout in ("tied", "sliced") for T in (1, 37, 300)
              for V in (1, 1000, 2049) for d in (64, 2048)]
    cases += [dict(T=37, d=12, V=1000, layout="tied", dtype=torch.bfloat16)]
    # phase 30's two heads, a backward chunk of each
    cases += [dict(T=CE_CHUNK_TOKENS, d=d, V=V, layout=layout, dtype=torch.bfloat16, arch=arch)
              for arch, (_, d, V, layout) in CE_ARCH_SHAPES.items()]
    before = ce_probs.launches
    worst = {"scalar": 0.0, "mma": 0.0}
    main_share, main_err, n_runs = 0.0, 0.0, 0
    for i, c in enumerate(cases):
        T, V, dtype = c["T"], c["V"], c["dtype"]
        hidden, head, labels = ce_inputs(T, c["d"], V, dtype, c["layout"], 200 + i)
        if T > 3:
            labels[1], labels[2] = -1, V
        gen = torch.Generator(device="cuda").manual_seed(300 + i)
        g = (torch.rand(T, generator=gen, device="cuda") + 0.5) / T
        h32, w32 = hidden.float(), head.float()
        _, lse = fused_cross_entropy_ref(h32, w32, labels)
        p_one = ce_probs_ref(h32, w32, labels, lse, torch.ones_like(g))
        p32 = p_one * g[:, None]
        hit = (labels >= 0) & (labels < V)
        rows = torch.arange(T, device="cuda")[hit]
        p_one[rows, labels[hit].long()] += 1.0
        tol = ce_probs_tol(p32, p_one, g, lse, dtype)
        routes = ["scalar"] + (["mma"] if _route(hidden, head) == "mma" else [])
        require(dtype == torch.float32 or c["d"] % 8 or "mma" in routes,
                f"an aligned bf16 case does not take the tensor-core route: {c}")
        require("arch" not in c or "mma" in routes,
                f"{c.get('arch')}'s training chunk does not take the tensor-core route: {c}")
        for route in routes:
            p = probs_routed(hidden, head, labels, lse, g, route)
            torch.cuda.synchronize()
            n_runs += 1
            require(p.shape == (T, V) and p.dtype == dtype, f"ce_probs output {c}")
            share = float(((p.float() - p32).abs() / tol).max())
            worst[route] = max(worst[route], share)
            main = c.get("main") and route == "mma"
            if main:
                main_share, main_err = share, float((p.float() - p32).abs().max())
            if c.get("main") or share > 1.0 or (T, V) == (37, 1) or "arch" in c:
                print(f"  T={T:4d} d={c['d']:4d} V={V:6d} {str(dtype)[6:]:8s} "
                      f"{c['layout']:6s} {route:6s}: max error {share:.3f} of the allowance"
                      f"{' [the training chunk]' if c.get('main') else ''}"
                      + (f" [{c['arch']}'s training chunk]" if "arch" in c else "")
                      + (" ok" if share <= 1.0 else " FAIL"))
            require(share <= 1.0, f"ce_probs {route} disagrees with its plain version: {c}")
            del p
        del p_one, p32, tol
    require(ce_probs.launches - before == n_runs, "one ce_probs launch per run")

    hidden, head, labels = ce_inputs(8, 16, 40, torch.bfloat16, "tied", 0)
    lse, g = torch.zeros(8, device="cuda"), torch.ones(8, device="cuda")
    n_ref = check_refusals("ce_probs", ce_probs, {
        "the tensor-core route forced on fp32": lambda: _launch_probs(
            hidden.float(), head.float(), labels, lse, g, "mma"),
        "the tensor-core route forced on d = 12": lambda: _launch_probs(
            hidden[:, :12], head[:12], labels, lse, g, "mma"),
        "an unknown route": lambda: _launch_probs(hidden, head, labels, lse, g, "wgmma"),
        "a strided last axis": lambda: ce_probs(hidden.T.contiguous().T, head, labels, lse, g),
        "a bf16 lse": lambda: ce_probs(hidden, head, labels, lse.bfloat16(), g),
        "g of another length": lambda: ce_probs(hidden, head, labels, lse, g[:7]),
        "hidden that requires grad": lambda: ce_probs(hidden.clone().requires_grad_(), head,
                                                      labels, lse, g),
    })
    print(f"kernels: ce_probs cuda ok ({len(cases)} cases, {n_runs} runs; max error of one "
          f"rounding + |g| (1e-6 + p * 1e-5 * max(1, |lse|)): scalar route "
          f"{worst['scalar']:.3f}, tensor-core route {worst['mma']:.3f}, {main_share:.3f} at "
          f"the training chunk (max_abs_err {main_err:.3e}); {n_ref} refusals)")
    return main_err


def check_flash_lse():
    """The flash kernel's lse output against the plain
    ``blocked_attention(return_lse=True)``, within 1e-5 * max(1, |lse|); the
    output beside it is unchanged by asking for it."""
    from repro_torch.kernels.flash_attention import flash_attention_ref

    worst = 0.0
    cases = [(B, S, S, H, K, D, dtype, mask)
             for dtype in (torch.float32, torch.bfloat16) for mask in ("causal", "window", "full")
             for (B, S, H, K, D) in ((1, 37, 4, 2, 64), (2, 300, 8, 1, 256), (1, 2047, 32, 8, 128),
                                     FLASH_SHAPES["gemma-2b train"], (1, 2047, 16, 16, 192),
                                     (2, 300, 8, 2, 192))]
    # non-causal at Sq != Sk (cross-attention's backward reads this lse)
    cases += [(B, Sq, Sk, H, K, 64, dtype, "full")
              for dtype in (torch.float32, torch.bfloat16)
              for (B, Sq, Sk, H, K) in ((2, 37, 130, 8, 2), (2, 130, 37, 8, 2),
                                        (1, 2048, 4096, 16, 16))]
    for i, (B, S, Sk, H, K, D, dtype, mask) in enumerate(cases):
        q, k, v = flash_inputs(B, S, Sk, H, K, D, dtype, 100 + i)
        causal, window = mask != "full", FLASH_WINDOW if mask == "window" else 0
        route = "mma" if dtype == torch.bfloat16 else "scalar"
        out, lse = flash_routed(q, k, v, route, causal=causal, window=window, return_lse=True)
        plain = flash_routed(q, k, v, route, causal=causal, window=window)
        _, ref_lse = flash_attention_ref(q.float(), k.float(), v.float(), causal=causal,
                                         window=window, return_lse=True)
        torch.cuda.synchronize()
        err = float((lse - ref_lse).abs().max()) / max(1.0, float(ref_lse.abs().max()))
        worst = max(worst, err)
        require(lse.shape == (B, S, H) and lse.dtype == torch.float32, "lse shape")
        require(torch.equal(out, plain), "asking for lse changed the output")
        if err > 1e-5:
            raise AssertionError(f"flash_attention lse disagrees: "
                                 f"{(B, S, Sk, H, K, D, dtype, mask)} rel {err:.3e}")
    print(f"kernels: flash_attention lse ok ({len(cases)} cases, bf16 on the tensor-core "
          f"route, fp32 on the scalar one; max error {worst:.3e} of max(1, |lse|), tol 1e-5; "
          f"the output equals the call without lse)")
    return worst


def check_flash_training():
    """FlashAttention at the training shapes in bf16 (phase 30's three
    SeamlessM4T shapes, phase 31's MLA at D = 192 and GQA 28/4 at D = 128):
    the forward's output and lse (``flash_attention(return_lse=True)``, the
    tensor-core route) against the plain ``flash_attention_ref`` in fp32,
    within one bf16 ulp + 1e-5 max|v| and 1e-5 max(1, |lse|); then dq, dk, dv
    of ``ops.mha_flash_train`` (the kernel's forward, then the plain
    ``flash_attention_bwd``) against the same backward from the plain
    forward's output and lse, within FLASH_GRAD_RTOL (rel L2) each. Returns
    the worst relative gradient error."""
    from repro_torch.kernels import ops
    from repro_torch.kernels.flash_attention import flash_attention, flash_attention_ref
    from repro_torch.models.attention_core import flash_attention_bwd

    worst = 0.0
    for i, (tag, (B, Sq, Sk, H, K, D, causal)) in enumerate(FLASH_TRAIN_SHAPES.items()):
        q, k, v = flash_inputs(B, Sq, Sk, H, K, D, torch.bfloat16, 400 + i)
        g = torch.randn(q.shape, generator=torch.Generator(device="cuda").manual_seed(500 + i),
                        device="cuda").to(q.dtype)
        out, lse = flash_routed(q, k, v, "mma", causal=causal, return_lse=True)
        ref32, ref_lse = flash_attention_ref(q.float(), k.float(), v.float(), causal=causal,
                                             return_lse=True)
        ok, share = close_to_fp32(out, ref32, float(v.float().abs().max()))
        lse_err = float((lse - ref_lse).abs().max()) / max(1.0, float(ref_lse.abs().max()))
        del ref32, ref_lse
        n, tc = flash_attention.launches, flash_attention.tc_launches
        leaves = [t.detach().clone().requires_grad_() for t in (q, k, v)]
        got = torch.autograd.grad(ops.mha_flash_train(*leaves, causal=causal), leaves, g)
        require(flash_attention.launches == n + 1 and flash_attention.tc_launches == tc + 1,
                f"{tag}: FlashAttention's forward did not launch once on the tensor-core route")
        plain_out, plain_lse = flash_attention_ref(q, k, v, causal=causal, return_lse=True)
        want = flash_attention_bwd(q, k, v, plain_out, plain_lse, g, causal=causal)
        errs = [float((a.float() - b.float()).norm() / b.float().norm())
                for a, b in zip(got, want)]
        finite = all(bool(torch.isfinite(a).all()) for a in got)
        worst = max([worst] + errs)
        print(f"  {tag}: B={B} Sq={Sq} Sk={Sk} H/K={H}/{K} D={D} bf16 "
              f"{'causal' if causal else 'non-causal'}, tensor-core route: output max_err="
              f"{share:.3f} of (1 bf16 ulp + tol), lse {lse_err:.2e} of max(1, |lse|) (tol "
              f"1e-5); dq/dk/dv rel L2 {', '.join(f'{e:.2e}' for e in errs)} against the plain "
              f"forward's backward (tol {FLASH_GRAD_RTOL:g})")
        require(ok and lse_err <= 1e-5 and finite and max(errs) <= FLASH_GRAD_RTOL,
                f"FlashAttention disagrees with its plain version at {tag}")
        del q, k, v, g, out, lse, leaves, got, plain_out, plain_lse, want
    print(f"kernels: FlashAttention at the {len(FLASH_TRAIN_SHAPES)} training shapes ok "
          f"(gradients within {worst:.2e} rel L2)")
    return worst


def check_grad_guard():
    """Every kernel wrapper refuses, launching nothing, an input that requires
    grad while grad mode is on, and takes it under torch.no_grad()."""
    from repro_torch.kernels.ce_loss import ce_probs, fused_cross_entropy
    from repro_torch.kernels.fedavg_agg import fedavg_aggregate
    from repro_torch.kernels.flash_attention import flash_attention
    from repro_torch.kernels.gossip_mix import gossip_mix
    from repro_torch.kernels.quantized_agg import (
        packed_quantized_aggregate,
        quantized_aggregate,
    )
    from repro_torch.kernels.sparse_agg import sparse_aggregate
    from repro_torch.kernels.ssm_scan import ssm_scan, ssm_scan_bwd

    rg = lambda t: t.clone().requires_grad_()   # noqa: E731
    w = normalized(2)
    x = torch.randn((2, 512), device="cuda")
    lo, scale = ranges(2, 1, seed=0)
    codes = random_codes(2, 512, torch.uint8, seed=0)
    words = torch.zeros((2, 512 // 32), dtype=torch.int32, device="cuda")   # 1-bit codes
    idx = torch.tensor([[0, 3], [1, 3]], dtype=torch.int32, device="cuda")
    vals = torch.randn((2, 2), device="cuda")
    mix_idx = torch.tensor([[0, 1], [1, 0]], dtype=torch.int32, device="cuda")
    mix_w = torch.full((2, 2), 0.5, device="cuda")
    q, k, v = flash_inputs(1, 8, 8, 2, 1, 16, torch.float32, 0)
    dt, Bm, Cm, xs, A, h0 = ssm_inputs(1, 4, 8, 4, torch.float32, 0, 0.0)
    _, _, ck = ssm_scan(dt, Bm, Cm, xs, A, h0, checkpoints=True)
    gy = torch.ones_like(xs)
    hidden, head, labels = ce_inputs(8, 16, 40, torch.float32, "tied", 0)
    hb, wb = hidden.bfloat16(), head.bfloat16()
    lse, g = torch.zeros(8, device="cuda"), torch.ones(8, device="cuda")
    calls = {
        "fedavg_aggregate": lambda f: fedavg_aggregate(f(x), w),
        "quantized_aggregate": lambda f: quantized_aggregate(codes, f(lo), scale, w, chunk=512,
                                                             levels=255),
        "packed_quantized_aggregate": lambda f: packed_quantized_aggregate(
            words, f(lo), scale, w, bits=1, chunk=512, levels=1),
        "sparse_aggregate": lambda f: sparse_aggregate(idx, f(vals), w, 4),
        "gossip_mix": lambda f: gossip_mix(f(x), mix_idx, mix_w),
        "flash_attention": lambda f: flash_attention(f(q), k, v),
        "ssm_scan": lambda f: ssm_scan(dt, Bm, Cm, f(xs), A, h0),
        "fused_cross_entropy": lambda f: fused_cross_entropy(f(hidden), head, labels),
        "ce_probs": lambda f: ce_probs(f(hb), wb, labels, lse, g),
        "ssm_scan_bwd": lambda f: ssm_scan_bwd(dt, Bm, Cm, f(xs), A, h0, gy, checkpoints=ck),
    }
    wrappers = counters()
    for name, call in calls.items():
        before = wrappers[name].launches
        try:
            call(rg)
        except ValueError as e:
            require("gradient would be dropped" in str(e), f"{name} refused for another reason: {e}")
            print(f"  {name} refuses an input that requires grad: ValueError")
        else:
            raise AssertionError(f"{name} accepted an input that requires grad")
        require(wrappers[name].launches == before, f"a refused {name} call launched the kernel")
        with torch.no_grad():
            call(rg)
        require(wrappers[name].launches == before + 1, f"{name} under no_grad did not launch")
    torch.cuda.synchronize()
    print(f"kernels: grad guard ok ({len(calls)} wrappers refuse a requires_grad input under "
          "grad mode and launch nothing; each launches under torch.no_grad())")


def old_plain_ce_backward(hidden, head, labels, lse, g, chunk):
    """The CE backward as ``ops.FusedCrossEntropy`` took it before the
    ce_probs kernel, kept here to time the new one against it (and, in
    fp32 on the CPU, ``tests/test_torch_ce_route.py`` holds the new one to
    it bit for bit): the head widened to fp32 once, fp32 logits and softmax
    of each chunk, and the two products in fp32."""
    T = hidden.shape[0]
    V = head.shape[1]
    lbl = labels.long()
    head32 = head.float()
    dhidden = torch.empty_like(hidden)
    dhead = torch.zeros(head.shape, dtype=torch.float32, device=head.device)
    for t0 in range(0, T, chunk):
        sl = slice(t0, t0 + chunk)
        h_c = hidden[sl].float()
        p = torch.matmul(h_c, head32).sub_(lse[sl, None]).exp_()
        hit = (lbl[sl] >= 0) & (lbl[sl] < V)
        rows = torch.arange(p.shape[0], device=p.device)
        p[rows, lbl[sl].clamp(0, V - 1)] -= hit.float()
        p *= g[sl, None]
        dhidden[sl] = (p @ head32.T).to(hidden.dtype)
        dhead.addmm_(h_c.T, p)
    return dhidden, dhead.to(head.dtype)


def time_fused_cross_entropy():
    """At the training step's shape, bf16, the head a tied view. The
    forward: the tensor-core route (the one ``fused_cross_entropy`` takes
    here) and the scalar route (through the module's private launcher) in
    turns, scalar, tensor cores, tensor cores, scalar (5 launches each, the
    mean of each route's two medians), which must be at least
    CE_MIN_SPEEDUP apart; the plain version (3) and the two-call yardstick
    (hidden @ head, then F.cross_entropy over the 4.2 GB of fp32 logits it
    materializes; 5). Bound: 2 T d V flops on the bf16 tensor cores against
    head and hidden read once and the two (T,) outputs written once.

    ce_probs on one chunk of CE_CHUNK_TOKENS (20 launches) against its
    scalar route (through the module's private launcher; 3) and
    ce_probs_ref (3); bound: the chunk's 2 n d V flops against hidden's
    chunk and the head read once and P written once. The whole backward
    (``ops.ce_backward`` over CE_CHUNKS chunks; 5) against the plain one it
    replaced (3); bound 3 x 2 T d V flops (P's logits again and the two
    products) against hidden and head read and dhidden and dhead written
    once."""
    from repro_torch.kernels import ops
    from repro_torch.kernels.ce_loss import (
        _launch,
        _launch_probs,
        ce_probs,
        ce_probs_ref,
        fused_cross_entropy,
        fused_cross_entropy_ref,
    )

    T, d, V = CE_SHAPE
    hidden, head, labels = ce_inputs(T, d, V, torch.bfloat16, "tied", 7)
    lbl64 = labels.long()
    flush = flush_buffer()

    def yardstick():
        return torch.nn.functional.cross_entropy((hidden @ head).float(), lbl64,
                                                 reduction="none")

    flops = 2 * T * d * V
    nbytes = (T * d + d * V) * 2 + T * 4 + 2 * T * 4
    t_bytes, t_ops = nbytes / HBM_BYTES_PER_S, flops / BF16_FLOPS
    ce_routed(hidden, head, labels, "mma")
    routes = {"scalar": lambda: _launch(hidden, head, labels, "scalar"),
              "mma": lambda: fused_cross_entropy(hidden, head, labels)}
    turns = [(name, time_ms(routes[name], flush, iters=3, warmup=1))
             for name in ("scalar", "mma", "mma", "scalar")]
    tc_ms = float(np.mean([t for name, t in turns if name == "mma"]))
    scalar_ms = float(np.mean([t for name, t in turns if name == "scalar"]))
    r = {"ms": tc_ms,
         "plain_ms": time_ms(lambda: fused_cross_entropy_ref(hidden, head, labels), flush,
                             iters=3, warmup=1),
         "library_ms": time_ms(yardstick, flush, iters=5, warmup=1),
         "bound_ms": max(t_bytes, t_ops) * 1e3,
         "bound_by": "bytes" if t_bytes >= t_ops else "operations",
         "bytes": nbytes, "flops": flops, "T": T, "d": d, "V": V, "dtype": "bfloat16",
         "head": "tied view (V, d).T", "route": "mma", "scalar_ms": scalar_ms,
         "turns_ms": turns, "speedup": scalar_ms / tc_ms}
    r["bound_share"] = r["bound_ms"] / r["ms"]
    r["achieved_TFLOPs"] = flops / (r["ms"] * 1e-3) / 1e12
    r["scalar_TFLOPs"] = flops / (scalar_ms * 1e-3) / 1e12
    r["vs_library"] = tc_ms / r["library_ms"]
    print(f"  fused_cross_entropy T={T} d={d} V={V} bf16, tied head, tensor-core route: "
          f"kernel_ms={r['ms']:.3f} bound_ms={r['bound_ms']:.3f} ({r['bound_by']}; "
          f"{r['bound_share']:.1%} of bound, {r['achieved_TFLOPs']:.1f} TFLOP/s) "
          f"plain_ms={r['plain_ms']:.3f} yardstick_ms={r['library_ms']:.3f} (matmul then "
          f"F.cross_entropy: two calls)")
    print(f"    turns (scalar, mma, mma, scalar): " + ", ".join(f"{t:.3f}" for _, t in turns)
          + f" ms; scalar route {r['scalar_TFLOPs']:.1f} TFLOP/s; tensor cores "
          f"{r['speedup']:.2f}x faster than the scalar route, {r['vs_library']:.2f}x the "
          f"yardstick's time")
    require(r["speedup"] >= CE_MIN_SPEEDUP,
            f"fused_cross_entropy: the tensor-core route is only {r['speedup']:.2f}x faster "
            f"than the scalar route (want >= {CE_MIN_SPEEDUP})")

    # the backward's pieces, from the tensor-core forward's lse and the mean's
    # upstream gradient
    _, lse = fused_cross_entropy(hidden, head, labels)
    g = torch.full((T,), 1.0 / T, device="cuda")
    n = CE_CHUNK_TOKENS
    p_flops = 2 * n * d * V
    p_bytes = (n * d + d * V) * 2 + n * 12 + n * V * 2
    pb, po = p_bytes / HBM_BYTES_PER_S, p_flops / BF16_FLOPS
    sl = slice(0, n)
    probs = {"ms": time_ms(lambda: ce_probs(hidden[sl], head, labels[sl], lse[sl], g[sl]),
                           flush, iters=20, warmup=2),
             "scalar_ms": time_ms(lambda: _launch_probs(hidden[sl], head, labels[sl], lse[sl],
                                                        g[sl], "scalar"), flush, iters=3,
                                  warmup=1),
             "plain_ms": time_ms(lambda: ce_probs_ref(hidden[sl], head, labels[sl], lse[sl],
                                                      g[sl]), flush, iters=3, warmup=1),
             "library_ms": None,
             "bound_ms": max(pb, po) * 1e3, "bound_by": "bytes" if pb >= po else "operations",
             "bytes": p_bytes, "flops": p_flops, "T": n, "d": d, "V": V, "dtype": "bfloat16",
             "head": "tied view (V, d).T"}
    probs["bound_share"] = probs["bound_ms"] / probs["ms"]
    probs["achieved_TFLOPs"] = p_flops / (probs["ms"] * 1e-3) / 1e12
    print(f"  ce_probs {n} tokens d={d} V={V} bf16, tied head: kernel_ms={probs['ms']:.3f} "
          f"bound_ms={probs['bound_ms']:.3f} ({probs['bound_by']}; "
          f"{probs['bound_share']:.1%} of bound, {probs['achieved_TFLOPs']:.1f} TFLOP/s) "
          f"plain_ms={probs['plain_ms']:.3f} library_ms=none (no one PyTorch call); the "
          f"scalar route (ce_probs_kernel) {probs['scalar_ms']:.3f} ms")

    b_flops = 3 * flops
    b_bytes = 2 * (T * d + d * V) * 2 + T * 12
    bb, bo = b_bytes / HBM_BYTES_PER_S, b_flops / BF16_FLOPS
    bwd = {"ms": time_ms(lambda: ops.ce_backward(hidden, head, labels, lse, g, n), flush,
                         iters=5, warmup=1),
           "old_plain_ms": time_ms(lambda: old_plain_ce_backward(hidden, head, labels, lse, g, n),
                                   flush, iters=3, warmup=1),
           "bound_ms": max(bb, bo) * 1e3, "bound_by": "bytes" if bb >= bo else "operations",
           "flops": b_flops, "bytes": b_bytes, "chunk": n, "chunks": CE_CHUNKS}
    bwd["bound_share"] = bwd["bound_ms"] / bwd["ms"]
    new, old = ops.ce_backward(hidden, head, labels, lse, g, n), \
        old_plain_ce_backward(hidden, head, labels, lse, g, n)
    for what, a, b in (("dhidden", new[0], old[0]), ("dhead", new[1], old[1])):
        bwd[f"{what}_rel_diff_vs_old"] = float((a.float() - b.float()).norm() / b.float().norm())
    del new, old
    print(f"  the CE backward (ops.ce_backward, {CE_CHUNKS} chunks of {n} tokens): "
          f"{bwd['ms']:.3f} ms, bound {bwd['bound_ms']:.3f} ms ({bwd['bound_by']}; "
          f"{bwd['bound_share']:.1%} of bound); the old plain backward {bwd['old_plain_ms']:.3f} "
          f"ms ({bwd['old_plain_ms'] / bwd['ms']:.2f}x); dhidden and dhead differ from it by "
          f"{bwd['dhidden_rel_diff_vs_old']:.2e} and {bwd['dhead_rel_diff_vs_old']:.2e} "
          f"(rel L2, both bf16)")
    r["backward"] = bwd
    del hidden, head, labels, lbl64, lse, g
    rows = {"gemma-2b train": r, **time_arch_ce(flush)}
    del flush
    return rows, {"gemma-2b train chunk": probs}


def time_arch_ce(flush):
    """The CE at the training steps of phases 30 and 31 (CE_ARCH_SHAPES but
    xLSTM's: T = 4096 tokens of SeamlessM4T's untied V = 256,206 head at d =
    1024, DeepSeek-V2-Lite's 102,400 at 2048, Qwen2-VL's 152,064 at 3584) on
    the tensor-core route, the way ``ops.FusedCrossEntropy`` runs it: the
    kernel on the head as ``train_loss`` passes it (20 launches), and where
    the head's pitch is no multiple of 8 (SeamlessM4T's) the staging copy
    (``ops.tensor_core_head`` of the contiguous head, a (d, V') buffer) timed
    alone and the kernel on the staged view; the plain version (3) and
    ``hidden @ head`` then ``F.cross_entropy`` (5). Bound as the tied
    row's, plus the copy's read and write of the head where it is staged."""
    from repro_torch.kernels.ce_loss import fused_cross_entropy, fused_cross_entropy_ref
    from repro_torch.kernels.ops import tensor_core_head

    rows = {}
    for arch in ("seamless-m4t-medium", "deepseek-v2-lite-16b", "qwen2-vl-7b"):
        T, d, V, layout = CE_ARCH_SHAPES[arch]
        staged = layout == "staged"
        hidden, passed, labels = ce_inputs(T, d, V, torch.bfloat16, layout, 8)
        head = passed.contiguous()
        require(not staged or passed.stride() == (-(-V // 8) * 8, 1),
                f"the staged head's strides {passed.stride()}")
        lbl64 = labels.long()
        ce_routed(hidden, passed, labels, "mma")
        flops = 2 * T * d * V
        nbytes = (T * d + (3 if staged else 1) * d * V) * 2 + T * 4 + 2 * T * 4
        t_bytes, t_ops = nbytes / HBM_BYTES_PER_S, flops / BF16_FLOPS
        r = {"ms": time_ms(lambda: fused_cross_entropy(hidden, passed, labels), flush,
                           iters=20, warmup=2),
             "staging_ms": (time_ms(lambda: tensor_core_head(hidden, head), flush, iters=20,
                                    warmup=2) if staged else 0.0),
             "plain_ms": time_ms(lambda: fused_cross_entropy_ref(hidden, head, labels), flush,
                                 iters=3, warmup=1),
             "library_ms": time_ms(lambda: torch.nn.functional.cross_entropy(
                 (hidden @ head).float(), lbl64, reduction="none"), flush, iters=5, warmup=1),
             "bound_ms": max(t_bytes, t_ops) * 1e3,
             "bound_by": "bytes" if t_bytes >= t_ops else "operations",
             "bytes": nbytes, "flops": flops, "T": T, "d": d, "V": V, "dtype": "bfloat16",
             "head": ("(d, V) contiguous, staged to a (d, V') buffer's view" if staged
                      else "(d, V) contiguous"), "route": "mma"}
        r["with_staging_ms"] = r["ms"] + r["staging_ms"]
        r["bound_share"] = r["bound_ms"] / r["with_staging_ms"]
        r["achieved_TFLOPs"] = flops / (r["ms"] * 1e-3) / 1e12
        r["vs_library"] = r["with_staging_ms"] / r["library_ms"]
        print(f"  fused_cross_entropy {arch} train: T={T} d={d} V={V} bf16, the head "
              + (f"staged (pitch {passed.stride(0)})" if staged else "contiguous")
              + f", tensor-core route: kernel_ms={r['ms']:.3f}"
              + (f" + staging copy {r['staging_ms']:.3f} ms" if staged else "")
              + f", bound_ms={r['bound_ms']:.3f} ({r['bound_by']}; {r['bound_share']:.1%} of "
              f"bound{' with the copy' if staged else ''}, {r['achieved_TFLOPs']:.1f} TFLOP/s) "
              f"plain_ms={r['plain_ms']:.3f} library_ms={r['library_ms']:.3f} (matmul then "
              f"F.cross_entropy; the kernel{' and copy' if staged else ''} take"
              f"{'' if staged else 's'} {r['vs_library']:.2f}x its time)")
        rows[f"{arch} train"] = r
        del hidden, passed, head, labels, lbl64
    return rows


# ---------------------------------------------------------------------------
# phases 14-17: serving the LM substrate
# ---------------------------------------------------------------------------

def prompt_tokens(vocab, B, S, seed=0):
    r = np.random.default_rng(seed)
    return torch.from_numpy(r.integers(0, vocab, (B, S)).astype(np.int32)).cuda()


def serving_prompt(cfg, B, S, seed=0, frames=SEAMLESS_FRAMES):
    """A prompt batch on the card: token ids, or for the vision stub (B, S, d)
    stub embeddings drawn on the card and (B, S, 3) M-RoPE positions whose
    components differ (t; a 32-wide patch grid's row and column); the audio
    stub adds (B, ``frames``, d) encoder embeddings drawn on the card."""
    if cfg.modality == "audio":
        g = torch.Generator(device="cuda").manual_seed(seed)
        return {"tokens": prompt_tokens(cfg.vocab_size, B, S, seed),
                "enc_embeds": torch.randn((B, frames, cfg.d_model), generator=g, device="cuda")}
    if cfg.modality != "vision":
        return {"tokens": prompt_tokens(cfg.vocab_size, B, S, seed)}
    g = torch.Generator(device="cuda").manual_seed(seed)
    embeds = torch.randn((B, S, cfg.d_model), generator=g, device="cuda")
    t = torch.arange(S, dtype=torch.int32, device="cuda")
    pos = torch.stack([t, t // 32, t % 32], dim=-1)[None].expand(B, S, 3).contiguous()
    return {"embeds": embeds, "positions": pos}


def prompt_slice(batch, sl):
    """The prompt's positions ``sl``; the encoder's frames whole."""
    return {k: v if k == "enc_embeds" else v[:, sl] for k, v in batch.items()}


def n_flash_layers(model):
    """Flash launches a prefill: each attention or MLA mixer, each
    cross-attention and each encoder layer once."""
    return (sum((s.mixer in ("attn", "mla")) + s.cross for s in model.plan)
            + len(model.enc_plan))


def serving_lane(label, model, params):
    """One request as a user sends it: prefill of B = 4 prompts of 2048
    tokens (or stub embeddings), then greedy decode to 32 tokens (31 decode
    steps), through ``repro_torch.launch.serve.generate``, after one short
    warm-up request. Every launch count is set to 0 just before and read
    just after."""
    from repro_torch.kernels.ssm_scan import launch_plan
    from repro_torch.launch.serve import generate

    cfg = model.cfg
    prompt = serving_prompt(cfg, SERVE_BATCH, PROMPT)
    generate(model, params, prompt_slice(prompt, slice(0, 64)), 3)
    torch.cuda.synchronize()
    torch.cuda.reset_peak_memory_stats()
    held = torch.cuda.memory_allocated()
    reset_counts()
    ids, prefill_s, decode_s = generate(model, params, prompt, SERVE_TOKENS)
    counts, tc = launch_counts(), flash_tc_launches()
    lanes = dict(counters()["ssm_scan"].lane_launches)
    peak = torch.cuda.max_memory_allocated()
    n_attn = n_flash_layers(model)
    n_mamba = sum(s.mixer == "mamba" for s in model.plan)
    want = {k: 0 for k in KERNELS}
    want.update(flash_attention=n_attn, ssm_scan=n_mamba * SERVE_TOKENS)
    require(counts == want, f"{label}: launches {counts}, want {want}")
    require(tc == n_attn, f"{label}: {tc} of {n_attn} flash launches took the tensor-core route")
    want_lanes = dict.fromkeys(lanes, 0)
    if n_mamba:
        want_lanes[launch_plan(PROMPT)] += n_mamba
        want_lanes[launch_plan(1)] += n_mamba * (SERVE_TOKENS - 1)
    require(lanes == want_lanes, f"{label}: ssm_scan launches by lanes a channel {lanes}, "
            f"want the launch plan's {want_lanes}")
    require(peak / 2**30 < PEAK_LIMIT_GIB, f"{label}: peak {peak / 2**30:.2f} GiB")
    ids = ids.cpu()
    require(ids.shape == (SERVE_BATCH, SERVE_TOKENS) and int(ids.min()) >= 0
            and int(ids.max()) < cfg.vocab_size, f"{label}: bad sampled ids")
    ms_token = decode_s / (SERVE_TOKENS - 1) * 1e3
    print(f"  {label}: prefill {SERVE_BATCH}x{PROMPT} {prefill_s:.4f} s "
          f"({SERVE_BATCH * PROMPT / prefill_s:.0f} tokens/s), decode {ms_token:.3f} ms/token "
          f"({SERVE_TOKENS - 1} steps, {SERVE_BATCH} seqs), peak device memory "
          f"{peak / 2**30:.2f} GiB ({held / 2**30:.2f} GiB held before the request, params "
          f"included); launches: flash_attention {counts['flash_attention']} "
          f"({n_attn} a prefill; {tc} on the tensor-core route), ssm_scan {counts['ssm_scan']} ({n_mamba} a prefill + "
          f"{n_mamba} x {SERVE_TOKENS - 1} decode steps; by lanes a channel "
          f"{ {k: v for k, v in lanes.items() if v} }); ids[0][:8] {ids[0, :8].tolist()}")
    return {"model": label, "batch": SERVE_BATCH, "prompt": PROMPT, "tokens": SERVE_TOKENS,
            "prefill_s": prefill_s, "decode_ms_per_token": ms_token,
            "peak_device_GiB": peak / 2**30, "held_before_GiB": held / 2**30,
            "launches": counts, "flash_tc_launches": tc, "ssm_lane_launches": lanes}


def no_drop(cfg):
    """``cfg`` with an MoE capacity that drops nothing: cap = ceil(gs * k / E
    * cf) >= gs, the whole group, at cf = E / k (at least 8, as before: a
    token group can send every token to one expert, and at cf 8 V3's 256
    experts top-8 hold only a quarter of a group, which one prompt's last
    token overflowed on an H100)."""
    if cfg.moe is None:
        return cfg
    cf = max(8.0, cfg.moe.n_experts / cfg.moe.topk)
    return dataclasses.replace(cfg, moe=dataclasses.replace(cfg.moe, capacity_factor=cf))


def lm_invariant(label, model, params, shape=INVARIANT_SHAPE, rtol=INVARIANT_RTOL):
    """The reference's own invariant (tests/test_arch_smoke.py) at full width
    in the model's dtype: prefill of S - 1 tokens (or stub embeddings; the
    audio stub's INVARIANT_FRAMES frames whole), then one decode step on the
    last token alone, gives the logits that a forward over S tokens gives at
    the last position; MoE at a capacity that drops nothing (``no_drop``).
    The two paths round at other places (other matmul shapes, the flash
    kernel against decode_attention, MLA's naive against its absorbed
    form), so the logits are held to ``rtol`` of their largest magnitude;
    ``rtol`` None measures the gap and holds only finite logits."""
    from repro_torch.models.transformer import TransformerLM

    m = TransformerLM(no_drop(model.cfg), device="cuda")
    B, S = shape
    batch = serving_prompt(m.cfg, B, S, seed=1, frames=INVARIANT_FRAMES)
    hidden, _, _ = m.forward(params, batch, mode="train")
    full = (hidden[:, -1:] @ m._head(params)).float()
    caches, _ = m.prefill(params, prompt_slice(batch, slice(0, S - 1)), cache_len=S)
    last = prompt_slice({k: v for k, v in batch.items() if k != "enc_embeds"},
                        slice(S - 1, S))
    if "tokens" in last:
        last["pos_offset"] = S - 1
    logits, _ = m.decode_step(params, last, caches)
    require(bool(torch.isfinite(logits).all()) and bool(torch.isfinite(full).all())
            and logits.shape == full.shape, f"{label}: bad logits")
    err = float((logits - full).abs().max())
    scale = float(full.abs().max())
    agree = float((logits.argmax(-1) == full.argmax(-1)).float().mean())
    dtype = str(m.dtype).replace("torch.", "")
    held = "not held" if rtol is None else f"tol {rtol:.3%}"
    print(f"  {label}: B={B} S={S} {dtype}, max |decode - forward| {err:.4e} of max |logit| "
          f"{scale:.4f} ({err / scale:.4%}; {held}); argmax agree {agree:.2f}")
    require(rtol is None or err <= rtol * scale, f"{label}: prefill+decode != forward")
    return {"model": label, "dtype": dtype, "batch": B, "seq": S, "max_abs_err": err,
            "max_abs_logit": scale, "rtol": rtol}


def block_invariant(label, what, run, d_model, dtype, shape, rtol, new_cache=None,
                    seeds=(1,)):
    """One block at full width in ``dtype``: the last token of prefill (S - 1
    tokens into a cache) + one decode step against the same block's prefill
    over all S tokens, on unit-normal inputs drawn on the card from each of
    ``seeds``, held to ``rtol`` of the largest output. ``run(x, positions,
    cache, mode)`` applies the block and returns (out, cache); ``new_cache``
    makes the empty cache the shorter prefill fills, where the block takes
    one."""
    B, S = shape
    pos = torch.arange(S, device="cuda")[None].expand(B, S)
    out = []
    for seed in seeds:
        g = torch.Generator(device="cuda").manual_seed(seed)
        x = torch.randn((B, S, d_model), generator=g, device="cuda").to(dtype)
        full, _ = run(x, pos, None, "prefill")
        _, cache = run(x[:, :-1], pos[:, :-1], new_cache and new_cache(), "prefill")
        last, _ = run(x[:, -1:], pos[:, -1:], cache, "decode")
        want = full[:, -1:].float()
        err = float((last.float() - want).abs().max())
        scale = float(want.abs().max())
        print(f"  {label}: {what}, B={B} S={S} {str(dtype)[6:]}, input seed {seed}, max |decode "
              f"- prefill| {err:.4e} of max |out| {scale:.4f} ({err / scale:.3%}; tol "
              f"{rtol:.3%})")
        require(bool(torch.isfinite(last).all()) and err <= rtol * scale,
                f"{label}: {what}'s decode != its prefill (input seed {seed})")
        out.append({"model": f"{label} {what}", "batch": B, "seq": S, "seed": seed,
                    "max_abs_err": err, "max_abs_out": scale, "rtol": rtol})
    return out


def mla_layer_invariant(label, model, params):
    """The first MLA layer of ``model`` (``block_invariant``): the decode step
    in the absorbed form against the naive up-projection through the flash
    kernel, at MLA_INVARIANT_SHAPE, held to MLA_LAYER_RTOL."""
    from repro_torch.models.layers import init_mla_cache, mla_apply
    from repro_torch.utils.tree import tree_map

    cfg = model.cfg
    p = tree_map(lambda a: a[0], params["layers"][0]["sub0"]["mixer"])
    B, S = MLA_INVARIANT_SHAPE

    def run(x, pos, cache, mode):
        return mla_apply(p, cfg, x, positions=pos, cache=cache, mode=mode)[:2]

    return block_invariant(label, "one MLA layer", run, cfg.d_model, model.dtype,
                           MLA_INVARIANT_SHAPE, MLA_LAYER_RTOL,
                           new_cache=lambda: init_mla_cache(cfg, B, S, model.dtype, "cuda"))


def reduced_card_vs_cpu(arch):
    """The reduced config in fp32: prefill + 3 decode steps on the card
    against the CPU on the same params (the kernels against their plain
    versions, end to end), held to the reference's own consistency bound on
    the logits and to 1e-4 on every cache leaf. The vision stub decodes on
    zero embeddings at S + t, as ``serve.generate`` feeds it."""
    from repro_torch.configs import get_config
    from repro_torch.configs.base import reduced
    from repro_torch.models.transformer import TransformerLM
    from repro_torch.utils.tree import tree_leaves, tree_map

    cfg = reduced(get_config(arch))
    gpu, cpu = TransformerLM(cfg, device="cuda"), TransformerLM(cfg, device="cpu")
    params = gpu.init(0)
    params_cpu = tree_map(lambda t: t.cpu(), params)
    prompt = serving_prompt(cfg, 2, 40, seed=2, frames=16)
    c_gpu, l_gpu = gpu.prefill(params, prompt, cache_len=44)
    c_cpu, l_cpu = cpu.prefill(params_cpu, {k: v.cpu() for k, v in prompt.items()}, cache_len=44)
    logit_err = cache_err = 0.0
    for step in range(4):
        logit_err = max(logit_err, float((l_gpu.cpu() - l_cpu).abs().max()))
        cache_err = max(cache_err, max(float((a.cpu().double() - b.double()).abs().max())
                                       for a, b in zip(tree_leaves(c_gpu), tree_leaves(c_cpu))))
        if step == 3:
            break
        if cfg.modality == "vision":
            batch = {"embeds": torch.zeros((2, 1, cfg.d_model)),
                     "positions": torch.full((2, 1, 3), 40 + step, dtype=torch.int32)}
        else:
            batch = {"tokens": torch.argmax(l_cpu[:, -1], dim=-1)[:, None],
                     "pos_offset": 40 + step}
        l_gpu, c_gpu = gpu.decode_step(
            params, {k: (v.cuda() if torch.is_tensor(v) else v) for k, v in batch.items()},
            c_gpu)
        l_cpu, c_cpu = cpu.decode_step(params_cpu, batch, c_cpu)
    print(f"  reduced {arch} fp32, prefill 2x40 + 3 decode steps: card vs CPU logits "
          f"max_abs_err {logit_err:.3e} (tol {REDUCED_LOGITS_ATOL}), cache leaves "
          f"{cache_err:.3e} (tol {REDUCED_CACHE_ATOL})")
    require(logit_err <= REDUCED_LOGITS_ATOL and cache_err <= REDUCED_CACHE_ATOL,
            f"reduced {arch}: card and CPU disagree")
    return {"arch": arch, "logits_err": logit_err, "cache_err": cache_err}


def profile_serving(label, model, params):
    """One prefill (B = 4, 2048 tokens) and one decode step under
    torch.profiler: device busy (the union of the ops' intervals) against
    the host wall, the top ops, the two kernels' share, and the launches the
    wrappers counted in each (set to 0 just before)."""
    cfg = model.cfg
    prompt = serving_prompt(cfg, SERVE_BATCH, PROMPT)
    box = {}

    def prefill():
        box["caches"], box["logits"] = model.prefill(params, prompt,
                                                     cache_len=PROMPT + SERVE_TOKENS)

    def decode():
        if cfg.modality == "vision":
            step = {"embeds": torch.zeros((SERVE_BATCH, 1, cfg.d_model), device="cuda"),
                    "positions": torch.full((SERVE_BATCH, 1, 3), PROMPT, dtype=torch.int32,
                                            device="cuda")}
        else:
            step = {"tokens": torch.argmax(box["logits"][:, -1], dim=-1)[:, None],
                    "pos_offset": PROMPT}
        model.decode_step(params, step, box["caches"])

    out = {}
    for what, fn in (("prefill", prefill), ("decode step", decode)):
        reset_counts()
        wall, ops, rows = device_profile(fn)
        counted = {k: v for k, v in launch_counts().items() if v}
        busy = busy_seconds((e.time_range.start, e.time_range.end) for e in ops)
        summed = sum(e.time_range.elapsed_us() for e in ops) / 1e6
        shares = {}
        for key, kernel in (("flash_fwd", "flash_attention"),   # both routes' kernels
                            ("ssm_scan_", "ssm_scan")):
            mine = [r for r in rows if key in r[2]]
            shares[kernel] = {"ms": sum(r[0] for r in mine) / 1e3,
                              "count": sum(r[1] for r in mine)}
        print(f"  {label} {what}: wall {wall:.4f} s under the profiler, device busy "
              f"{busy:.4f} s (idle share {1 - busy / wall:.1%}; ops summed {summed:.4f} s), "
              f"{len(ops)} device ops; "
              + ", ".join(f"{k} {v['count']}x {v['ms']:.3f} ms ({v['ms'] / 1e3 / busy:.1%} of busy)"
                          for k, v in shares.items()))
        for us, count, k in rows[:8]:
            print(f"    {us / 1e3:10.3f} ms {count:6d}x  {k[:90]}")
        print(f"    launches counted by the wrappers: {counted}")
        out[what] = {"wall_s": wall, "device_busy_s": busy, "idle_share": 1 - busy / wall,
                     "device_ops": len(ops), "kernels": shares, "launches": counted}
    return out


# ---------------------------------------------------------------------------
# phases 18-20: training the LM substrate
# ---------------------------------------------------------------------------

def gemma_leaf_count():
    from repro_torch.configs import get_config
    from repro_torch.models.transformer import TransformerLM
    from repro_torch.utils.tree import tree_leaves

    return len(tree_leaves(TransformerLM(get_config("gemma-2b"), device="meta").param_shapes()))


def free_card():
    gc.collect()
    torch.cuda.empty_cache()


def training_lane():
    """Gemma-2B whole through ``repro_torch.launch.train.main``: 2 FedAvg
    rounds (G = 2 groups x H = 2 local AdamW steps), then 4 FedSGD steps
    (each group's 4 optimizer steps, taken by one model, so the two loss
    curves compare step for step). Every count is set to 0 just before each run and read just after; each
    round must launch ``fused_cross_entropy`` G·H times, all on the
    tensor-core route, ``ce_probs`` G·H·CE_CHUNKS times (each step's
    backward, a chunk of B * ce_chunk tokens at a time), ``flash_attention``
    G·H·18·2 times (each layer's forward and its remat recompute) and
    ``fedavg_aggregate`` once a parameter leaf, and nothing else."""
    from repro_torch.launch import train

    n_leaves = gemma_leaf_count()
    steps = TRAIN_G * TRAIN_H
    per_round = {"fused_cross_entropy": steps, "ce_probs": steps * CE_CHUNKS,
                 "flash_attention": steps * 18 * 2, "ssm_scan": 0, "ssm_scan_bwd": 0,
                 "fedavg_aggregate": n_leaves}
    out = {}
    for algo, argv, per in (
            ("fedavg", TRAIN_ARGV, per_round),
            ("fedsgd", TRAIN_ARGV + ["--algo", "fedsgd"],
             {"fused_cross_entropy": 1, "ce_probs": CE_CHUNKS, "flash_attention": 36,
              "ssm_scan": 0, "ssm_scan_bwd": 0, "fedavg_aggregate": 0})):
        free_card()
        held = torch.cuda.memory_allocated()
        reset_counts()
        recs = train.main(argv)
        counts, tc, ce_tc = launch_counts(), flash_tc_launches(), ce_tc_launches()
        probs_tc = probs_tc_launches()
        free_card()
        want = {k: 0 for k in KERNELS}
        want.update({k: v * len(recs) for k, v in per.items()})
        require(counts == want, f"training {algo}: launches {counts}, want {want}")
        require(tc == want["flash_attention"], f"training {algo}: {tc} of "
                f"{want['flash_attention']} flash launches took the tensor-core route")
        require(ce_tc == want["fused_cross_entropy"], f"training {algo}: {ce_tc} of "
                f"{want['fused_cross_entropy']} CE launches took the tensor-core route")
        require(probs_tc == want["ce_probs"], f"training {algo}: {probs_tc} of "
                f"{want['ce_probs']} ce_probs launches took the tensor-core route")
        for rec in recs:
            require(rec["launches"] == per, f"training {algo}: {rec['launches']} != {per}")
            require(math.isfinite(rec["loss"]), f"training {algo}: loss {rec['loss']}")
        peak = max(rec["peak_GiB"] for rec in recs)
        what = "round" if algo == "fedavg" else "step"
        for rec in recs:
            print(f"  {algo} {what} {rec.get('round', rec.get('step'))}: {rec['seconds']:.3f} s, "
                  f"{rec['tokens']} tokens, {rec['tokens_per_s']:.0f} tokens/s, loss "
                  f"{rec['loss']:.4f}, peak device memory {rec['peak_GiB']:.2f} GiB, launches "
                  + ", ".join(f"{k} {v}" for k, v in rec["launches"].items()))
        print(f"  {algo}: {len(recs)} {what}s, launches in all {want} (flash_attention {tc}, "
              f"fused_cross_entropy {ce_tc} on the tensor-core route); peak {peak:.2f} GiB "
              f"({held / 2**30:.2f} GiB held before); {n_leaves} parameter leaves")
        require(peak <= PEAK_LIMIT_GIB, f"training {algo}: peak {peak:.2f} GiB over "
                f"{PEAK_LIMIT_GIB} GiB")
        out[algo] = {"records": recs, "launches": counts, "flash_tc_launches": tc,
                     "ce_tc_launches": ce_tc, "probs_tc_launches": probs_tc,
                     "peak_GiB": peak, "argv": argv}
    return out


def reduced_round_card_vs_cpu(arch):
    """One FedAvg round (G = 2, H = 2) of the reduced config in fp32 on the
    card against the same round on the CPU, from the same params and
    batches: first one step's gradients, every leaf within TRAIN_RTOL; then
    the kernels' forwards, the CE gradient's ce_probs (all on their
    scalar routes, required), the scan's backward kernel and the plain
    attention backward against the plain versions end to end (Jamba's 8
    layers: one attention, 7 Mamba, 4 MoE; each Mamba layer launches
    ``ssm_scan`` and ``ssm_scan_bwd`` once a step; xLSTM's mLSTM and sLSTM
    blocks, no kernel but the CE's; SeamlessM4T over REDUCED_TRAIN_FRAMES
    frames, flash once a step in each encoder layer, decoder self-attention
    and cross-attention; DeepSeek-V2-Lite and V3, a dense layer and an MLA +
    MoE layer, flash at the reduced qk head dim; Qwen2-VL on stub
    embeddings and M-RoPE positions, its QKV biases, its embedding table
    unread, so 0 in every gradient, update and moment on both devices). A
    leaf of ZERO_GRAD_LEAVES, whose gradient is 0 in
    exact arithmetic, is held by its norm on both devices. Twice: with SGD at
    REDUCED_SGD_LR, whose update is linear in the gradients, the loss and
    the update (the whole tree's, in L2, and each of UPDATE_LEAVES') within
    TRAIN_RTOL; with
    AdamW, the local optimizer of the main path, the loss and the groups'
    moments mu and nu (linear and quadratic in the gradients; the trees and
    each of MOMENT_LEAVES) within TRAIN_RTOL, at REDUCED_ADAMW_LR. The AdamW
    update itself is not compared: its first steps are lr * g / |g|, so a
    gradient element at rounding level steps by +-lr on either side."""
    from repro_torch.configs import get_config
    from repro_torch.configs.base import reduced
    from repro_torch.core import local_sgd
    from repro_torch.models.transformer import TransformerLM
    from repro_torch.optim import adamw, sgd
    from repro_torch.utils.tree import tree_leaves, tree_map, tree_paths

    cfg = reduced(get_config(arch))
    r = np.random.default_rng(5)
    shape = (TRAIN_H, TRAIN_G, 2, 40)
    batches = {k: torch.from_numpy(r.integers(0, cfg.vocab_size, shape).astype(np.int32))
               for k in ("tokens", "labels")}
    if cfg.modality == "vision":
        # the reference's train layout: embeddings in place of the tokens,
        # and M-RoPE positions whose height and width differ from t
        del batches["tokens"]
        batches["embeds"] = torch.from_numpy(
            r.normal(size=shape + (cfg.d_model,)).astype(np.float32))
        t = np.broadcast_to(np.arange(shape[-1]), shape)
        batches["positions"] = torch.from_numpy(np.stack(
            [t, r.integers(0, 9, shape), r.integers(0, 9, shape)], axis=-1).astype(np.int32))
    if cfg.modality == "audio":
        batches["enc_embeds"] = torch.from_numpy(
            r.normal(size=shape[:3] + (REDUCED_TRAIN_FRAMES, cfg.d_model)).astype(np.float32))
    start = TransformerLM(cfg, device="cuda").init(0)
    plan = TransformerLM(cfg, device="cuda").plan
    n_attn = n_flash_layers(TransformerLM(cfg, device="meta"))
    n_mamba = sum(s.mixer == "mamba" for s in plan)
    paths = ["/".join(map(str, p)) for p in tree_paths(start)]
    steps = TRAIN_G * TRAIN_H
    step_tokens = shape[2] * shape[3]
    chunks = -(-step_tokens // (shape[2] * cfg.ce_chunk)) if cfg.ce_chunk else 1

    def rel_l2(got, want):
        num = math.sqrt(sum(float(((a - b) ** 2).sum()) for a, b in zip(got, want)))
        return num / math.sqrt(sum(float((b ** 2).sum()) for b in want))

    def rel_leaf(a, b):
        # 0 where both are 0 (the vision stub's embedding table: no token
        # is looked up, so its gradient, update and moments are 0 on both
        # devices)
        if not b.any():
            return 0.0 if not a.any() else math.inf
        return float((a - b).norm() / b.norm())

    # one step's gradients, card against CPU, every leaf
    grads = {}
    for dev in ("cuda", "cpu"):
        p = tree_map(lambda t: t.detach().to(dev).requires_grad_(), start)
        loss, _ = TransformerLM(cfg, device=dev).train_loss(
            p, {k: v[0, 0].to(dev) for k, v in batches.items()})
        grads[dev] = [g.cpu().double() for g in torch.autograd.grad(
            loss, tree_leaves(p), materialize_grads=True)]
    zero = {pth: max(float(a.norm()), float(b.norm()))
            for pth, a, b in zip(paths, grads["cuda"], grads["cpu"])
            if pth.split("/")[-1] in ZERO_GRAD_LEAVES}
    grad_err = {pth: rel_leaf(a, b)
                for pth, a, b in zip(paths, grads["cuda"], grads["cpu"]) if pth not in zero}
    worst_grad = max(grad_err, key=grad_err.get)
    print(f"  reduced {arch} fp32, one step's gradients, card vs CPU: {len(grad_err)} leaves, "
          f"worst {grad_err[worst_grad]:.2e} ({worst_grad}) (tol {TRAIN_RTOL:g})"
          + (f"; {len(zero)} leaves whose gradient is 0 in exact arithmetic, largest norm "
             f"{max(zero.values()):.2e} on either device (tol {ZERO_GRAD_ATOL:g})" if zero else ""))
    require(grad_err[worst_grad] <= TRAIN_RTOL, f"reduced {arch}: a gradient leaf disagrees")
    require(all(v <= ZERO_GRAD_ATOL for v in zero.values()),
            f"reduced {arch}: a gradient that is 0 in exact arithmetic is not: {zero}")
    out = {"arch": arch, "gradient_worst_rel_err": grad_err[worst_grad],
           "gradient_worst_leaf": worst_grad}
    del grads
    adamw_lr = REDUCED_ADAMW_LR.get(arch, REDUCED_ADAMW_LR[None])
    for name, make in (("SGD", lambda: sgd(REDUCED_SGD_LR)), ("AdamW", lambda: adamw(adamw_lr))):
        results = {}
        for dev in ("cuda", "cpu"):
            model = TransformerLM(cfg, device=dev)
            params_g = local_sgd.replicate_for_groups(tree_map(lambda t: t.to(dev), start),
                                                      TRAIN_G)
            opt = make()
            step = local_sgd.build_fedavg_round_step(model.train_loss, opt,
                                                     local_sgd.LocalSGDConfig(TRAIN_G, TRAIN_H))
            reset_counts()
            params_g, inner_g, _, m = step(
                params_g, local_sgd.init_group_states(opt, params_g), None,
                tree_map(lambda t: t.to(dev), batches), torch.tensor([1.0, 3.0]))
            if dev == "cuda":
                tc = (flash_tc_launches(), ce_tc_launches(), probs_tc_launches())
            moments = ([t.cpu().double() for t in tree_leaves(inner_g.mu)
                        + tree_leaves(inner_g.nu)] if name == "AdamW" else None)
            results[dev] = (float(m["loss"]), launch_counts(),
                            [(p[0].cpu().double() - s.cpu().double())
                             for p, s in zip(tree_leaves(params_g), tree_leaves(start))],
                            moments)
        (l_gpu, n_gpu, u_gpu, m_gpu), (l_cpu, _, u_cpu, m_cpu) = results["cuda"], results["cpu"]
        want = {k: 0 for k in KERNELS}
        want.update(fused_cross_entropy=steps, ce_probs=steps * chunks,
                    flash_attention=steps * n_attn, ssm_scan=steps * n_mamba,
                    ssm_scan_bwd=steps * n_mamba, fedavg_aggregate=len(u_gpu))
        require(n_gpu == want, f"reduced {arch} {name} round: launches {n_gpu}, want {want}")
        require(tc == (0, 0, 0), f"reduced {arch} {name} round: fp32 took a tensor-core "
                f"route (flash, CE, ce_probs: {tc})")
        l_err = abs(l_gpu - l_cpu) / abs(l_cpu)
        n = len(paths)
        # (what, rel L2 of the tree, per-leaf (got, want) of the checked leaves)
        if name == "SGD":
            checks, checked = [("update", u_gpu, u_cpu)], UPDATE_LEAVES
        else:
            checks = [("mu", m_gpu[:n], m_cpu[:n]), ("nu", m_gpu[n:], m_cpu[n:])]
            checked = MOMENT_LEAVES
        tree_err = {k: rel_l2(g, w) for k, g, w in checks}
        leaf_err = {f"{k} {p}": rel_leaf(a, b)
                    for k, g, w in checks for p, a, b in zip(paths, g, w)
                    if p.split("/")[-1] in checked}
        worst_key = max(leaf_err, key=leaf_err.get)
        worst_leaf = leaf_err[worst_key]
        if name == "SGD":   # not held: the other leaves' updates, in ulps of their values
            unheld = []
            for p, a, b, s0 in zip(paths, u_gpu, u_cpu, tree_leaves(start)):
                if p.split("/")[-1] in MOMENT_LEAVES and p.split("/")[-1] not in UPDATE_LEAVES:
                    v = s0.detach().float().cpu().abs()
                    ulp = (torch.nextafter(v, torch.full_like(v, math.inf)) - v).double()
                    unheld.append((rel_leaf(a, b), p,
                                   float((b.abs() / ulp).median())))
            if unheld:
                e, p, ulps = max(unheld)
                print(f"    (not held) the SGD update of Mamba's and the router's leaves: worst "
                      f"{e:.2e} ({p}), its median step {ulps:.1f} ulps of its values")
        lr = REDUCED_SGD_LR if name == "SGD" else adamw_lr
        print(f"  reduced {arch} fp32, one round G={TRAIN_G} H={TRAIN_H} {name} lr {lr:g}: loss "
              f"{l_gpu:.6f} vs CPU {l_cpu:.6f} (rel {l_err:.2e}); "
              + ", ".join(f"{k} rel L2 {e:.2e}" for k, e in tree_err.items())
              + f"; {len(leaf_err)} checked leaves, worst {worst_leaf:.2e} ({worst_key}) "
              f"(tol {TRAIN_RTOL:g}); launches {({k: v for k, v in n_gpu.items() if v})}")
        require(max([l_err, worst_leaf, *tree_err.values()]) <= TRAIN_RTOL,
                f"reduced {arch} {name}: the card's round and the CPU's disagree")
        out[name] = {"loss_rel_err": l_err, **{f"{k}_rel_err": e for k, e in tree_err.items()},
                     "checked_leaves_worst_rel_err": worst_leaf, "worst_leaf": worst_key}
    return out


def full_width_ce_checks():
    """Gemma-2B at full width in bf16: ``train_loss``'s ce against the CE of
    fp32 logits materialized from the same hidden; then FusedCrossEntropy's
    dhidden and dhead on a 512-token slice against autograd through
    materialized fp32 logits of the same bf16 values, rounded to bf16 alike."""
    from repro_torch.configs import get_config
    from repro_torch.kernels import ops
    from repro_torch.models.transformer import TransformerLM

    model = TransformerLM(get_config("gemma-2b"), device="cuda")
    params = model.init(0)
    r = np.random.default_rng(6)
    V, d = model.cfg.vocab_size, model.cfg.d_model
    batch = {k: torch.from_numpy(r.integers(0, V, (TRAIN_B, TRAIN_S)).astype(np.int32)).cuda()
             for k in ("tokens", "labels")}
    labels = batch["labels"].reshape(-1).long()
    with torch.no_grad():
        hidden = model.forward(params, batch, mode="train")[0]
        _, aux = model.train_loss(params, batch)
        logits = hidden.reshape(-1, d).float() @ params["embed"]["table"].float().T
        ref = float((torch.logsumexp(logits, -1)
                     - logits.gather(1, labels[:, None])[:, 0]).double().mean())
        del logits
    ce = float(aux["ce"])
    rel = abs(ce - ref) / abs(ref)
    print(f"  gemma-2b bf16 B={TRAIN_B} S={TRAIN_S}: train_loss ce {ce:.7f} vs materialized fp32 "
          f"CE {ref:.7f} (rel {rel:.2e}, tol {CE_MATERIALIZED_RTOL:g})")
    require(rel <= CE_MATERIALIZED_RTOL, "train_loss's ce disagrees with the materialized CE")

    n = 512 // TRAIN_B
    h = hidden[:, :n].detach().clone().requires_grad_()
    table = params["embed"]["table"].detach().clone().requires_grad_()
    lbl = batch["labels"][:, :n]
    probs_tc = probs_tc_launches()
    ops.ce_loss_mean(h, table.T, lbl, chunk=model.cfg.ce_chunk).backward()
    require(probs_tc_launches() == probs_tc + 1,
            "the full-width CE backward did not take ce_probs' tensor-core route once")
    hf = h.detach().float().requires_grad_()
    tf = table.detach().float().requires_grad_()
    torch.nn.functional.cross_entropy(hf.reshape(-1, d) @ tf.T, lbl.reshape(-1).long()).backward()
    errs = {}
    for what, got, want in (("dhidden", h.grad, hf.grad), ("dhead", table.grad, tf.grad)):
        want = want.to(got.dtype).float()
        errs[what] = float((got.float() - want).norm() / want.norm())
    print(f"  FusedCrossEntropy on {TRAIN_B * n} tokens, bf16: dhidden rel {errs['dhidden']:.2e}, "
          f"dhead rel {errs['dhead']:.2e} against autograd through fp32 logits (tol "
          f"{CE_GRAD_RTOL:g})")
    require(max(errs.values()) <= CE_GRAD_RTOL, "FusedCrossEntropy's gradients disagree")
    return {"ce": ce, "materialized_ce": ref, "ce_rel_err": rel, **errs}


# The port's torch.profiler ranges: the three backwards (kernels/ops.py) and
# the optimizer's update (core/local_sgd.py).
PROFILER_RANGES = ("flash_attention_bwd", "fused_cross_entropy_bwd", "ssm_scan_bwd",
                   "optimizer_update")


def read_trace(prof, names=()):
    """(device ops, ranges) of a finished profile, read in one pass over
    its raw kineto events (a profile of one training step holds millions,
    and each pass over them costs seconds): the ops as
    ``profiled_device_ops`` gives them, and {range: {"device_ms",
    "device_ops", "host_ms", "spans"}} for the host ranges of ``names``
    (``torch.profiler.record_function``): on the one stream, every device
    op from the first to the last of those whose launch call (matched by
    correlation id) falls inside one of the range's host spans, their summed
    durations and count; and the spans' summed host time. The profiler's op
    tree alone misses kernels that no torch op launches (ctypes launches,
    cuBLASLt's cuLaunchKernelEx launches)."""
    import bisect

    from torch.autograd import DeviceType

    results = prof.profiler.kineto_results
    t_start = results.trace_start_ns()
    cuda, cpu = DeviceType.CUDA, DeviceType.CPU
    on_device, launch_of, spans_of, ops = [], {}, {name: [] for name in names}, []
    for e in results.events():
        if e.device_type() == cuda:
            if e.is_user_annotation():
                continue
            a, b = e.start_ns(), e.end_ns()
            on_device.append((a, b, e.correlation_id()))
            if not getattr(e, "is_hidden_event", lambda: False)():
                ops.append(DeviceOp(e.name(), Span((a - t_start) / 1e3, (b - t_start) / 1e3),
                                    e.device_resource_id()))
        elif e.device_type() == cpu and names:
            name = e.name()
            if name in spans_of:
                spans_of[name].append((e.start_ns(), e.end_ns()))
            elif "aunch" in name and e.correlation_id():
                launch_of[e.correlation_id()] = e.start_ns()
    if not names:
        return ops, {}
    on_device.sort()
    starts = [a for a, _, _ in on_device]
    cum = list(itertools.accumulate((b - a for a, b, _ in on_device), initial=0))
    launched = sorted((launch_of[c], a, b) for a, b, c in on_device if c in launch_of)
    launch_times = [t for t, _, _ in launched]
    out = {}
    for name, spans in spans_of.items():
        total, n_ops = 0, 0
        for a, b in spans:
            mine = launched[bisect.bisect_left(launch_times, a):
                            bisect.bisect_right(launch_times, b)]
            if mine:
                lo = bisect.bisect_left(starts, min(k[1] for k in mine))
                hi = bisect.bisect_left(starts, max(k[2] for k in mine))
                total += cum[hi] - cum[lo]
                n_ops += hi - lo
        out[name] = {"device_ms": total / 1e6, "device_ops": n_ops,
                     "host_ms": sum(b - a for a, b in spans) / 1e6, "spans": len(spans)}
    return ops, out


def profile_training_step():
    """One training step of one group (Gemma-2B, B = 2 x 2048 tokens, AdamW,
    through ``build_fedsgd_train_step``) under torch.profiler with CPU and
    CUDA activity, after one warm-up step: device busy (the union of the
    kernels' intervals) against the host wall, the top kernels, and the
    shares of the CE forward kernels, ce_probs, the flash kernel and the
    backwards (each a ``torch.profiler`` range in ``kernels/ops.py``: the
    device time of the kernels launched inside it; the CE backward's holds
    ce_probs and its two cuBLAS products)."""
    from torch.autograd import DeviceType
    from torch.profiler import ProfilerActivity, profile

    from repro_torch.configs import get_config
    from repro_torch.core.local_sgd import build_fedsgd_train_step
    from repro_torch.models.transformer import TransformerLM
    from repro_torch.optim import adamw

    model = TransformerLM(get_config("gemma-2b"), device="cuda")
    params = model.init(0)
    opt = adamw(3e-3)
    box = {"state": opt.init(params)}
    step = build_fedsgd_train_step(model.train_loss, opt)
    r = np.random.default_rng(7)
    batch = {k: torch.from_numpy(r.integers(0, model.cfg.vocab_size, (TRAIN_B, TRAIN_S))
                                 .astype(np.int32)).cuda() for k in ("tokens", "labels")}

    def one():
        _, box["state"], m = step(params, box["state"], batch)
        return float(m["loss"])

    one()
    torch.cuda.synchronize()
    reset_counts()
    with profile(activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA]) as prof:
        t0 = time.perf_counter()
        one()
        wall = time.perf_counter() - t0
    counts, tc, ce_tc = launch_counts(), flash_tc_launches(), ce_tc_launches()
    probs_tc = probs_tc_launches()
    want = {k: 0 for k in KERNELS}
    want.update(fused_cross_entropy=1, ce_probs=CE_CHUNKS, flash_attention=36)
    require(counts == want, f"profiled step: launches {counts}, want {want}")
    require(tc == 36, f"profiled step: {tc} of 36 flash launches took the tensor-core route")
    require(ce_tc == 1, "profiled step: the CE launch did not take the tensor-core route")
    require(probs_tc == CE_CHUNKS, f"profiled step: {probs_tc} of {CE_CHUNKS} ce_probs "
            "launches took the tensor-core route")
    events = prof.events()
    ranges = ("flash_attention_bwd", "fused_cross_entropy_bwd", "optimizer_update")
    # the device copies of the ranges (user annotations) span their kernels
    # and the gaps between them: they are not kernels
    kernels = [e for e in events if e.device_type == DeviceType.CUDA
               and e.name not in PROFILER_RANGES
               and not getattr(e, "is_user_annotation", False)]
    busy = busy_seconds((e.time_range.start, e.time_range.end) for e in kernels)
    by_name = {}
    for e in kernels:
        us, count = by_name.get(e.name, (0.0, 0))
        by_name[e.name] = (us + e.time_range.elapsed_us(), count + 1)
    rows = sorted(((us, c, k) for k, (us, c) in by_name.items()), reverse=True)

    ce_fwd = ("ce_fwd_mma_kernel", "ce_partial_kernel", "ce_merge_kernel")
    shares = {
        # either route's partial kernel and the merge
        "fused_cross_entropy": (sum(us for us, _, k in rows
                                    if any(n in k for n in ce_fwd)) / 1e3,
                                sum(c for _, c, k in rows if any(n in k for n in ce_fwd[:2]))),
        "fused_cross_entropy (tensor-core kernel)": (
            sum(us for us, _, k in rows if "ce_fwd_mma_kernel" in k) / 1e3,
            sum(c for _, c, k in rows if "ce_fwd_mma_kernel" in k)),
        # inside the CE backward's range below; ce_probs_mma_kernel and
        # ce_probs_kernel, the two routes' kernels
        "ce_probs": (sum(us for us, _, k in rows if "ce_probs" in k) / 1e3,
                     sum(c for _, c, k in rows if "ce_probs" in k)),
        "ce_probs (tensor-core kernel)": (
            sum(us for us, _, k in rows if "ce_probs_mma_kernel" in k) / 1e3,
            sum(c for _, c, k in rows if "ce_probs_mma_kernel" in k)),
        # flash_fwd_mma_kernel and flash_fwd_kernel, the two routes' kernels
        "flash_attention": (sum(us for us, _, k in rows if "flash_fwd" in k) / 1e3,
                            sum(c for _, c, k in rows if "flash_fwd" in k)),
        "flash_attention (tensor-core kernel)": (
            sum(us for us, _, k in rows if "flash_fwd_mma_kernel" in k) / 1e3,
            sum(c for _, c, k in rows if "flash_fwd_mma_kernel" in k)),
        **{f"{name} (range)": (r["device_ms"], r["spans"])
           for name, r in read_trace(prof, ranges)[1].items()},
    }
    print(f"  gemma-2b one group step (B={TRAIN_B} x {TRAIN_S}, AdamW): wall {wall:.4f} s under the "
          f"profiler, device busy {busy:.4f} s (idle share {1 - busy / wall:.1%}), "
          f"{len(kernels)} device kernels; flash_attention {tc} of 36 launches and "
          f"fused_cross_entropy {ce_tc} of 1 on the tensor-core route")
    for k, (ms, count) in shares.items():
        print(f"    {k}: {count}x, {ms:.3f} ms ({ms / 1e3 / busy:.1%} of busy)")
    for us, count, k in rows[:10]:
        print(f"    {us / 1e3:10.3f} ms {count:6d}x  {k[:90]}")
    return {"wall_s": wall, "device_busy_s": busy, "idle_share": 1 - busy / wall,
            "device_kernels": len(kernels),
            "shares_ms": {k: v[0] for k, v in shares.items()},
            "top": [(us / 1e3, c, k[:120]) for us, c, k in rows[:10]]}


# ---------------------------------------------------------------------------
# phase 27: training Jamba
# ---------------------------------------------------------------------------

def jamba_train_config():
    from repro_torch.configs import get_config

    return dataclasses.replace(get_config("jamba-v0.1-52b"), n_layers=JAMBA_TRAIN_LAYERS)


def jamba_training_lane():
    """Jamba at full width cut to JAMBA_TRAIN_LAYERS layers through
    ``repro_torch.launch.train.run`` (``JAMBA_TRAIN_ARGV``): 2 FedAvg rounds
    of G = 2 groups x H = 2 AdamW steps (bf16 moments), bf16, remat. Every
    count is set to 0 just before the run and read just after; each round
    must launch ``ssm_scan`` G·H·2·2 times (2 Mamba layers, forward and
    remat recompute), all on the launch plan's lanes, ``ssm_scan_bwd`` G·H·2
    times, ``fused_cross_entropy`` G·H times and ``ce_probs`` G·H·chunks
    times on the tensor-core route, ``fedavg_aggregate`` once a parameter
    leaf, and nothing else: no ``flash_attention`` (the cut has no attention
    layer)."""
    from repro_torch.kernels.ssm_scan import launch_plan
    from repro_torch.launch import train
    from repro_torch.models.transformer import TransformerLM
    from repro_torch.utils.tree import tree_leaves

    cfg = jamba_train_config()
    plan = TransformerLM(cfg, device="meta").plan
    n_mamba = sum(s.mixer == "mamba" for s in plan)
    n_leaves = len(tree_leaves(TransformerLM(cfg, device="meta").param_shapes()))
    steps = TRAIN_G * TRAIN_H
    chunks = -(-TRAIN_B * TRAIN_S // (TRAIN_B * cfg.ce_chunk))
    per = {"fused_cross_entropy": steps, "ce_probs": steps * chunks, "flash_attention": 0,
           "ssm_scan": steps * n_mamba * 2, "ssm_scan_bwd": steps * n_mamba,
           "fedavg_aggregate": n_leaves}
    free_card()
    held = torch.cuda.memory_allocated()
    reset_counts()
    t0 = time.perf_counter()
    recs, final = train.run(JAMBA_TRAIN_ARGV)
    wall = time.perf_counter() - t0
    counts, ce_tc, probs_tc = launch_counts(), ce_tc_launches(), probs_tc_launches()
    lanes = dict(counters()["ssm_scan"].lane_launches)
    n_params = sum(int(t.numel()) for t in tree_leaves(final))
    del final
    free_card()
    want = {k: 0 for k in KERNELS}
    want.update({k: v * len(recs) for k, v in per.items()})
    require(counts == want, f"training jamba: launches {counts}, want {want}")
    require(ce_tc == want["fused_cross_entropy"] and probs_tc == want["ce_probs"],
            f"training jamba: {ce_tc} CE and {probs_tc} ce_probs launches on the tensor-core "
            f"route, want {want['fused_cross_entropy']} and {want['ce_probs']}")
    require(lanes[launch_plan(TRAIN_S)] == want["ssm_scan"],
            f"training jamba: ssm_scan launches by lanes {lanes}")
    for rec in recs:
        require(rec["launches"] == per, f"training jamba: {rec['launches']} != {per}")
        require(math.isfinite(rec["loss"]), f"training jamba: loss {rec['loss']}")
        print(f"  fedavg round {rec['round']}: {rec['seconds']:.3f} s, {rec['tokens']} tokens, "
              f"{rec['tokens_per_s']:.0f} tokens/s, loss {rec['loss']:.4f}, peak device memory "
              f"{rec['peak_GiB']:.2f} GiB, launches "
              + ", ".join(f"{k} {v}" for k, v in rec["launches"].items()))
    peak = max(rec["peak_GiB"] for rec in recs)
    print(f"  jamba {JAMBA_TRAIN_LAYERS} layers ({[s.mixer + '/' + s.ffn for s in plan]}), "
          f"{n_params:,} params, {n_leaves} leaves: {len(recs)} rounds in {wall:.1f} s with "
          f"set-up; launches in all {want}; peak {peak:.2f} GiB ({held / 2**30:.2f} GiB held "
          f"before)")
    require(peak <= PEAK_LIMIT_GIB, f"training jamba: peak {peak:.2f} GiB over "
            f"{PEAK_LIMIT_GIB} GiB")
    return {"records": recs, "launches": counts, "ssm_lane_launches": lanes,
            "ce_tc_launches": ce_tc, "probs_tc_launches": probs_tc, "peak_GiB": peak,
            "n_params": n_params, "wall_s": wall, "argv": JAMBA_TRAIN_ARGV}


def layer_ms(fn, inputs, leaves, grad_out, iters=3, warmup=True):
    """(forward ms, forward + backward ms) of ``fn(inputs)``, CUDA events
    around ``iters`` runs each after a warm-up (none where the caller's own
    run warmed the same shapes), the backward reaching ``inputs`` and
    ``leaves`` (the layer's params, which require grad)."""
    def fwd():
        with torch.no_grad():
            fn(inputs)

    def fwd_bwd():
        torch.autograd.backward(fn(inputs), grad_out)
        for t in [inputs] + leaves:
            t.grad = None

    res = []
    for f in (fwd, fwd_bwd):
        if warmup:
            f()
        a, b = torch.cuda.Event(enable_timing=True), torch.cuda.Event(enable_timing=True)
        a.record()
        for _ in range(iters):
            f()
        b.record()
        torch.cuda.synchronize()
        res.append(a.elapsed_time(b) / iters)
    return tuple(res)


def profile_jamba_step():
    """One training step of one group of phase 27's Jamba (B = 2 x 2048
    tokens, AdamW with bf16 moments, through ``build_fedsgd_train_step``)
    under torch.profiler, after a warm-up step: device busy against the host
    wall, the top kernels, and the shares of the scan's forward kernel,
    ``ssm_scan_bwd`` (its two kernels; its range), the CE, and AdamW (the
    ``optimizer_update`` range). Then each Mamba mixer and the MoE FFN
    alone at the step's shape, forward and forward + backward by CUDA
    events: under remat a layer's forward runs twice a step, so its share
    is (2 forward + backward) over the profiled step's busy time (the
    profiler's own cost is in that busy time, not in the layers' events)."""
    from torch.autograd import DeviceType
    from torch.profiler import ProfilerActivity, profile

    from repro_torch.core.local_sgd import build_fedsgd_train_step
    from repro_torch.models import ssm as ssm_mod
    from repro_torch.models.layers import moe_apply
    from repro_torch.models.transformer import TransformerLM
    from repro_torch.optim import adamw
    from repro_torch.utils.tree import tree_leaves, tree_map

    cfg = jamba_train_config()
    model = TransformerLM(cfg, device="cuda")
    params = model.init(0)
    opt = adamw(JAMBA_TRAIN_LR, state_dtype=torch.bfloat16)
    box = {"state": opt.init(params)}
    step = build_fedsgd_train_step(model.train_loss, opt)
    r = np.random.default_rng(8)
    batch = {k: torch.from_numpy(r.integers(0, cfg.vocab_size, (TRAIN_B, TRAIN_S))
                                 .astype(np.int32)).cuda() for k in ("tokens", "labels")}

    def one():
        _, box["state"], m = step(params, box["state"], batch)
        return float(m["loss"])

    one()
    torch.cuda.synchronize()
    reset_counts()
    with profile(activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA]) as prof:
        t0 = time.perf_counter()
        loss = one()
        wall = time.perf_counter() - t0
    counts = launch_counts()
    n_mamba = sum(s.mixer == "mamba" for s in model.plan)
    chunks = -(-TRAIN_B * TRAIN_S // (TRAIN_B * cfg.ce_chunk))
    want = {k: 0 for k in KERNELS}
    want.update(fused_cross_entropy=1, ce_probs=chunks, ssm_scan=2 * n_mamba,
                ssm_scan_bwd=n_mamba)
    require(counts == want and math.isfinite(loss),
            f"profiled jamba step: launches {counts}, want {want}; loss {loss}")
    kernels = [e for e in prof.events() if e.device_type == DeviceType.CUDA
               and e.name not in PROFILER_RANGES
               and not getattr(e, "is_user_annotation", False)]
    busy = busy_seconds((e.time_range.start, e.time_range.end) for e in kernels)
    by_name = {}
    for e in kernels:
        us, count = by_name.get(e.name, (0.0, 0))
        by_name[e.name] = (us + e.time_range.elapsed_us(), count + 1)
    rows = sorted(((us, c, k) for k, (us, c) in by_name.items()), reverse=True)

    def named(*keys):
        return (sum(us for us, _, k in rows if any(n in k for n in keys)) / 1e3,
                sum(c for _, c, k in rows if any(n in k for n in keys)))

    shares = {
        "ssm_scan (ssm_scan_ring_kernel)": named("ssm_scan_ring_kernel"),
        "ssm_scan_bwd (its two kernels)": named("ssm_scan_bwd_kernel",
                                                "ssm_scan_bwd_reduce_kernel"),
        "fused_cross_entropy and ce_probs": named("ce_fwd_mma_kernel", "ce_merge_kernel",
                                                  "ce_probs_mma_kernel"),
        **{f"{name} (range)": (r["device_ms"], r["spans"]) for name, r in read_trace(
            prof, ("ssm_scan_bwd", "fused_cross_entropy_bwd", "optimizer_update"))[1].items()},
    }
    print(f"  jamba one group step (B={TRAIN_B} x {TRAIN_S}, AdamW, bf16 moments): wall "
          f"{wall:.4f} s under the profiler, device busy {busy:.4f} s (idle share "
          f"{1 - busy / wall:.1%}), {len(kernels)} device kernels, loss {loss:.4f}")
    for k, (ms, count) in shares.items():
        print(f"    {k}: {count}x, {ms:.3f} ms ({ms / 1e3 / busy:.1%} of busy)")
    for us, count, k in rows[:10]:
        print(f"    {us / 1e3:10.3f} ms {count:6d}x  {k[:90]}")
    del box
    free_card()

    # each Mamba mixer and the MoE FFN alone, at the step's shape
    g = torch.Generator(device="cuda").manual_seed(3)
    h = torch.randn((TRAIN_B, TRAIN_S, cfg.d_model), generator=g, device="cuda",
                    dtype=model.compute_dtype).requires_grad_()
    grad_out = torch.randn(h.shape, generator=g, device="cuda", dtype=h.dtype)
    layers = {}
    for si, seg in enumerate(model.segments):
        for j, spec in enumerate(seg.specs):
            sub = params["layers"][si][f"sub{j}"]
            if spec.mixer == "mamba":
                p = tree_map(lambda a: a[0].detach().requires_grad_(), sub["mixer"])
                ms = layer_ms(lambda x, p=p: ssm_mod.mamba_apply(p, cfg, x)[0], h,
                              tree_leaves(p), grad_out)
                layers.setdefault("mamba mixer", []).append(ms)
            if spec.ffn == "moe":
                p = tree_map(lambda a: a[0].detach().requires_grad_(), sub["ffn"])
                ms = layer_ms(lambda x, p=p: moe_apply(p, cfg, x, cfg.act)[0], h,
                              tree_leaves(p), grad_out)
                layers.setdefault("moe ffn", []).append(ms)
    layer_shares = {}
    for k, mss in layers.items():
        step_ms = sum(2 * f + (fb - f) for f, fb in mss)
        layer_shares[k] = {"forward_ms": [f for f, _ in mss],
                           "forward_backward_ms": [fb for _, fb in mss],
                           "step_ms": step_ms, "share_of_busy": step_ms / 1e3 / busy}
        print(f"    {k} x{len(mss)}: forward " + ", ".join(f"{f:.3f}" for f, _ in mss)
              + " ms, forward + backward " + ", ".join(f"{fb:.3f}" for _, fb in mss)
              + f" ms alone; 2 forwards + backward {step_ms:.3f} ms a step "
              f"({step_ms / 1e3 / busy:.1%} of busy)")
    del params, h, grad_out
    free_card()
    return {"wall_s": wall, "device_busy_s": busy, "idle_share": 1 - busy / wall,
            "device_kernels": len(kernels), "loss": loss,
            "shares_ms": {k: v[0] for k, v in shares.items()}, "layers": layer_shares,
            "top": [(us / 1e3, c, k[:120]) for us, c, k in rows[:10]]}


def jamba_training_phase():
    """Phase 27: the training lane, then the profiled step."""
    t0 = time.perf_counter()
    out = {"lane": jamba_training_lane()}
    out["profile"] = profile_jamba_step()
    out["seconds"] = time.perf_counter() - t0
    print(f"  phase 27: launches {out['lane']['launches']} in {out['seconds']:.1f} s")
    return out


# ---------------------------------------------------------------------------
# phase 30: training xLSTM and SeamlessM4T whole
# ---------------------------------------------------------------------------

def arch_train_argv(arch, n_layers=None):
    """Phase 30's command line (the arch whole, fp32 moments), or phase
    31's (its widths cut to ``n_layers`` layers, bf16 moments)."""
    argv = ["--arch", arch, "--full", "--remat", "--groups", str(TRAIN_G), "--local-steps",
            str(TRAIN_H), "--global-batch", str(TRAIN_G * TRAIN_B), "--seq", str(TRAIN_S),
            "--rounds", "1", "--lr", str(ARCH_TRAIN_LR), "--device", "cuda"]
    if n_layers is not None:
        argv += ["--n-layers", str(n_layers), "--state-dtype", "bfloat16"]
    return argv


def arch_train_config(arch, n_layers=None):
    from repro_torch.configs import get_config

    cfg = dataclasses.replace(get_config(arch), remat=True)
    return cfg if n_layers is None else dataclasses.replace(cfg, n_layers=n_layers)


def arch_training_lane(arch, n_layers=None):
    """``arch`` through ``repro_torch.launch.train.run``
    (``arch_train_argv``): one FedAvg round of G = 2 groups x H = 2 AdamW
    steps, bf16, remat; whole with fp32 moments, or cut to ``n_layers``
    layers with bf16 moments. Every count is set to 0 just before
    the run and read just after; the round must launch ``flash_attention``
    G·H·2 times a flash layer (its forward and remat recompute: SeamlessM4T's
    12 encoder layers, 12 decoder self-attentions and 12 cross-attentions;
    an MLA or attention mixer a layer on DeepSeek and Qwen2-VL),
    ``fused_cross_entropy`` G·H times, ``ce_probs`` G·H·chunks times,
    ``fedavg_aggregate`` once a parameter leaf, and nothing else; every
    flash, CE and ``ce_probs`` launch on the tensor-core route (SeamlessM4T's
    CE through the staged head). The loss finite, the peak under
    PEAK_LIMIT_GIB."""
    from repro_torch.launch import train
    from repro_torch.models.transformer import TransformerLM
    from repro_torch.utils.tree import tree_leaves

    cfg = arch_train_config(arch, n_layers)
    moments = "fp32" if n_layers is None else "bf16"
    meta = TransformerLM(cfg, device="meta")
    n_leaves = len(tree_leaves(meta.param_shapes()))
    steps = TRAIN_G * TRAIN_H
    chunks = -(-TRAIN_B * TRAIN_S // (TRAIN_B * cfg.ce_chunk))
    per = {k: 0 for k in KERNELS}
    per.update(fused_cross_entropy=steps, ce_probs=steps * chunks,
               flash_attention=steps * n_flash_layers(meta) * 2, fedavg_aggregate=n_leaves)
    free_card()
    held = torch.cuda.memory_allocated()
    reset_counts()
    t0 = time.perf_counter()
    recs, final = train.run(arch_train_argv(arch, n_layers))
    wall = time.perf_counter() - t0
    counts = launch_counts()
    tc = {"flash_attention": flash_tc_launches(), "fused_cross_entropy": ce_tc_launches(),
          "ce_probs": probs_tc_launches()}
    n_params = sum(int(t.numel()) for t in tree_leaves(final))
    del final
    free_card()
    require(counts == per and len(recs) == 1, f"training {arch}: launches {counts}, want {per}")
    require(all(tc[k] == per[k] for k in tc),
            f"training {arch}: tensor-core launches {tc}, want all of {per}")
    rec = recs[0]
    require(rec["launches"] == {k: per[k] for k in rec["launches"]},
            f"training {arch}: the round's record {rec['launches']}")
    require(math.isfinite(rec["loss"]), f"training {arch}: loss {rec['loss']}")
    require(rec["peak_GiB"] <= PEAK_LIMIT_GIB,
            f"training {arch}: peak {rec['peak_GiB']:.2f} GiB over {PEAK_LIMIT_GIB} GiB")
    layers = ("" if n_layers is None else
              f" ({n_layers} layers: {[s.mixer + '/' + s.ffn for s in meta.plan]})")
    print(f"  {arch}{layers}: {n_params:,} params, {n_leaves} leaves, {moments} moments: one "
          f"FedAvg round of G={TRAIN_G} x H={TRAIN_H} on {TRAIN_B} x {TRAIN_S} tokens a group"
          + (f" over {min(TRAIN_S, 4096)} frames" if cfg.modality == "audio" else "")
          + (" of stub embeddings, M-RoPE positions" if cfg.modality == "vision" else "")
          + f": {rec['seconds']:.3f} s, {rec['tokens']} tokens, {rec['tokens_per_s']:.0f} "
          f"tokens/s, loss {rec['loss']:.4f}, peak device memory {rec['peak_GiB']:.2f} GiB "
          f"({held / 2**30:.2f} GiB held before); {wall:.1f} s with set-up; launches "
          + ", ".join(f"{k} {v}" for k, v in counts.items() if v)
          + " (every flash, CE and ce_probs launch on the tensor-core route)")
    return {"record": rec, "launches": counts, "tc_launches": tc, "n_params": n_params,
            "leaves": n_leaves, "wall_s": wall, "argv": arch_train_argv(arch, n_layers),
            "plan": [s.mixer + "/" + s.ffn for s in meta.plan]}


def profile_arch_step(arch, step_s, n_layers=None):
    """One group step of ``arch`` (B = 2 x 2048 tokens, and frames for the
    audio stub, embeddings and M-RoPE positions for the vision stub; AdamW,
    remat, through ``build_fedsgd_train_step``; whole with fp32 moments, or
    cut to ``n_layers`` layers with bf16 moments) under torch.profiler,
    right after the lane's round warmed the same shapes: device busy against
    the host wall, the device ops (the profiler's raw events), the top
    kernels, the hand kernels' shares, and the device time of the ranges
    ``optimizer_update``, ``fused_cross_entropy_bwd`` and
    ``flash_attention_bwd``, with CPU and CUDA activity (``read_trace``: the
    ranges are host spans, which a profile without CPU activity holds none
    of). For an MoE arch then each MoE FFN alone (:func:`moe_ffn_alone`).
    An arch of UNPROFILED_TRAIN (xLSTM) takes no profiled step, only its
    sLSTM layer alone (:func:`slstm_layer_alone`)."""
    from torch.profiler import ProfilerActivity, profile

    from repro_torch.core.local_sgd import build_fedsgd_train_step
    from repro_torch.models.transformer import TransformerLM
    from repro_torch.optim import adamw

    cfg = arch_train_config(arch, n_layers)
    model = TransformerLM(cfg, device="cuda")
    params = model.init(0)
    if arch in UNPROFILED_TRAIN:
        return slstm_layer_alone(cfg, model, params, step_s)
    opt = adamw(ARCH_TRAIN_LR, state_dtype=torch.float32 if n_layers is None else torch.bfloat16)
    box = {"state": opt.init(params)}
    step = build_fedsgd_train_step(model.train_loss, opt)
    r = np.random.default_rng(9)
    batch = {k: torch.from_numpy(r.integers(0, cfg.vocab_size, (TRAIN_B, TRAIN_S))
                                 .astype(np.int32)).cuda() for k in ("tokens", "labels")}
    if cfg.modality == "audio":
        batch["enc_embeds"] = torch.from_numpy(r.normal(size=(TRAIN_B, TRAIN_S, cfg.d_model))
                                               .astype(np.float32)).cuda().to(model.compute_dtype)
    if cfg.modality == "vision":
        del batch["tokens"]
        batch["embeds"] = torch.from_numpy(r.normal(size=(TRAIN_B, TRAIN_S, cfg.d_model))
                                           .astype(np.float32)).cuda().to(model.compute_dtype)
        batch["positions"] = torch.arange(TRAIN_S, dtype=torch.int32, device="cuda")[
            None, :, None].expand(TRAIN_B, TRAIN_S, 3).contiguous()
    torch.cuda.synchronize()
    reset_counts()
    with profile(activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA]) as prof:
        t0 = time.perf_counter()
        _, box["state"], m = step(params, box["state"], batch)
        loss = float(m["loss"])
        wall = time.perf_counter() - t0
    counts = launch_counts()
    t0 = time.perf_counter()
    ops, ranges = read_trace(prof, ("optimizer_update", "fused_cross_entropy_bwd",
                                    "flash_attention_bwd"))
    busy = busy_seconds((e.time_range.start, e.time_range.end) for e in ops)
    read_s = time.perf_counter() - t0
    del prof
    by_name = {}
    for e in ops:
        us, count = by_name.get(e.name, (0.0, 0))
        by_name[e.name] = (us + e.time_range.elapsed_us(), count + 1)
    rows = sorted(((us, c, k) for k, (us, c) in by_name.items()), reverse=True)
    hand = {k: (sum(us for us, _, n in rows if k in n) / 1e3, sum(c for _, c, n in rows if k in n))
            for k in ("flash_fwd_mma_kernel", "ce_fwd_mma_kernel", "ce_merge_kernel",
                      "ce_probs_mma_kernel")}
    chunks = -(-TRAIN_B * TRAIN_S // (TRAIN_B * cfg.ce_chunk))
    want = {k: 0 for k in KERNELS}
    want.update(fused_cross_entropy=1, ce_probs=chunks,
                flash_attention=2 * n_flash_layers(model))
    require(counts == want and math.isfinite(loss),
            f"profiled {arch} step: launches {counts}, want {want}; loss {loss}")
    print(f"  {arch} one group step (B={TRAIN_B} x {TRAIN_S}, AdamW, "
          f"{'fp32' if n_layers is None else 'bf16'} moments, remat) under "
          f"the profiler (CPU and CUDA activity): wall {wall:.4f} s, device busy {busy:.4f} s "
          f"(idle share {1 - busy / wall:.1%}), {len(ops)} device ops, loss {loss:.4f}; the "
          f"trace read in {read_s:.1f} s")
    print("    hand kernels: " + "; ".join(f"{k} {c}x {ms:.3f} ms ({ms / 1e3 / busy:.1%} of busy)"
                                           for k, (ms, c) in hand.items() if c))
    for name, rg in ranges.items():
        rg["share_of_busy"] = rg["device_ms"] / 1e3 / busy
        print(f"    range {name}: {rg['spans']} spans, {rg['device_ops']} device ops, "
              f"{rg['device_ms']:.3f} ms on the device ({rg['share_of_busy']:.1%} of busy), "
              f"{rg['host_ms']:.1f} ms of host time inside it")
    for us, count, k in rows[:8]:
        print(f"    {us / 1e3:10.3f} ms {count:7d}x  {k[:90]}")
    out = {"wall_s": wall, "device_busy_s": busy, "idle_share": 1 - busy / wall,
           "device_ops": len(ops), "loss": loss, "ranges": ranges, "read_s": read_s,
           "hand_kernels_ms": {k: v[0] for k, v in hand.items()},
           "top": [(us / 1e3, c, k[:120]) for us, c, k in rows[:8]]}
    del box, ops, rows
    free_card()
    if cfg.moe is not None:
        out["moe_ffn"] = moe_ffn_alone(cfg, model, params, busy)
    del params
    free_card()
    return out


def slstm_layer_alone(cfg, model, params, step_s):
    """xLSTM's first sLSTM layer alone at the training step's shape, one
    forward and one forward + backward between CUDA events (the loop is
    host-bound: the events time the host's pace), against ``step_s``, the
    lane's seconds a group step: a step runs 2 forwards (remat) and a
    backward of each of its sLSTM layers."""
    from repro_torch.models import xlstm
    from repro_torch.utils.tree import tree_leaves, tree_map

    seg = model.segments[0]
    j = [sp.mixer for sp in seg.specs].index("slstm")
    p = tree_map(lambda a: a[0].detach().requires_grad_(),
                 params["layers"][0][f"sub{j}"]["mixer"])
    g = torch.Generator(device="cuda").manual_seed(3)
    h = torch.randn((TRAIN_B, TRAIN_S, cfg.d_model), generator=g, device="cuda",
                    dtype=model.compute_dtype).requires_grad_()
    grad_out = torch.randn(h.shape, generator=g, device="cuda", dtype=h.dtype)
    f, fb = layer_ms(lambda x: xlstm.slstm_apply(p, cfg, x)[0], h, tree_leaves(p), grad_out,
                     iters=1, warmup=False)
    n_slstm = sum(sp.mixer == "slstm" for sp in model.plan)
    step_ms = n_slstm * (2 * f + (fb - f))
    print(f"    slstm layer alone: forward {f:.3f} ms, forward + backward {fb:.3f} ms between "
          f"CUDA events (one run each); x{n_slstm} layers with 2 forwards (remat) "
          f"{step_ms:.3f} ms a step, {step_ms / 1e3 / step_s:.1%} of the lane's "
          f"{step_s:.3f} s a group step")
    del h, grad_out, p, params
    free_card()
    return {"slstm_layer": {"forward_ms": f, "forward_backward_ms": fb, "layers": n_slstm,
                            "step_ms": step_ms, "share_of_step": step_ms / 1e3 / step_s}}


def moe_ffn_alone(cfg, model, params, busy):
    """Each MoE FFN alone at the training step's shape, forward and forward
    + backward by CUDA events (``layer_ms``), as phase 27 times Jamba's:
    under remat a layer's forward runs twice a step, so their share is (2
    forwards + backward) over the profiled step's ``busy`` seconds."""
    from repro_torch.models.layers import moe_apply
    from repro_torch.utils.tree import tree_leaves, tree_map

    g = torch.Generator(device="cuda").manual_seed(3)
    h = torch.randn((TRAIN_B, TRAIN_S, cfg.d_model), generator=g, device="cuda",
                    dtype=model.compute_dtype).requires_grad_()
    grad_out = torch.randn(h.shape, generator=g, device="cuda", dtype=h.dtype)
    mss = []
    for si, seg in enumerate(model.segments):
        for j, spec in enumerate(seg.specs):
            if spec.ffn != "moe":
                continue
            for li in range(seg.repeats):
                p = tree_map(lambda a, li=li: a[li].detach().requires_grad_(),
                             params["layers"][si][f"sub{j}"]["ffn"])
                mss.append(layer_ms(lambda x, p=p: moe_apply(p, cfg, x, cfg.act)[0], h,
                                    tree_leaves(p), grad_out))
    step_ms = sum(2 * f + (fb - f) for f, fb in mss)
    print(f"    moe ffn x{len(mss)}: forward " + ", ".join(f"{f:.3f}" for f, _ in mss)
          + " ms, forward + backward " + ", ".join(f"{fb:.3f}" for _, fb in mss)
          + f" ms alone; 2 forwards + backward {step_ms:.3f} ms a step "
          f"({step_ms / 1e3 / busy:.1%} of busy)")
    return {"forward_ms": [f for f, _ in mss], "forward_backward_ms": [fb for _, fb in mss],
            "step_ms": step_ms, "share_of_busy": step_ms / 1e3 / busy}


def archs_training_phase(archs=tuple((a, None) for a in ARCH_TRAIN), label="30"):
    """Phase 30 (or 31, with ``archs`` = MLA_VISION_TRAIN): each (arch,
    layers) of ``archs``, its training lane, then its profiled step
    (:func:`profile_arch_step`); each model freed before the next."""
    t0 = time.perf_counter()
    print(f"  memory_allocated at the start {torch.cuda.memory_allocated() / 2**30:.2f} GiB")
    out = {}
    for arch, n_layers in archs:
        t1 = time.perf_counter()
        lane = arch_training_lane(arch, n_layers)
        step_s = lane["record"]["seconds"] / (TRAIN_G * TRAIN_H)
        out[arch] = {"lane": lane, "profile": profile_arch_step(arch, step_s, n_layers)}
        out[arch]["seconds"] = time.perf_counter() - t1
        print(f"  {arch}: {out[arch]['seconds']:.1f} s with its profile")
    launches = {k: sum(a["lane"]["launches"][k] for a in out.values()) for k in KERNELS}
    print(f"  phase {label}: launches {({k: v for k, v in launches.items() if v})} in "
          f"{time.perf_counter() - t0:.1f} s")
    return {"archs": out, "launches": launches}


def mla_vision_training_phase():
    """Phase 31: DeepSeek-V2-Lite (MLA + MoE) and Qwen2-VL-7B (the vision
    stub) trained at full width, cut in depth (MLA_VISION_TRAIN), bf16
    moments; the round's launches as phase 30 requires them, which at these
    cuts are flash 32 (V2-Lite, 4 MLA layers) and 64 (Qwen2-VL, 8 layers),
    CE 4 and ``ce_probs`` 16, each on the tensor-core route: held here
    against MLA_VISION_TRAIN_LAUNCHES too, so that a cut of another depth
    cannot pass unseen."""
    out = archs_training_phase(MLA_VISION_TRAIN, "31")
    for arch, want in MLA_VISION_TRAIN_LAUNCHES.items():
        got = out["archs"][arch]["lane"]["launches"]
        require(all(got[k] == n for k, n in want.items()),
                f"training {arch}: launches {got}, want {want}")
    return out


# ---------------------------------------------------------------------------
# phases 5-9: the main paths
# ---------------------------------------------------------------------------

def host_vector(tree) -> torch.Tensor:
    from repro_torch.utils.tree import tree_map, tree_ravel

    return tree_ravel(tree_map(lambda p: p.detach().cpu().double(), tree))[0]


def noniid_clients(train, spec):
    """The clients of ``spec``'s (a spec's JSON dict) pathological non-IID
    partition of ``train``."""
    from repro_torch.data.partition import partition_pathological_noniid

    part = spec["partition"]
    require(part["kind"] == "pathological_noniid", f"unexpected spec {spec['name']}")
    split = partition_pathological_noniid(
        train.y, part["n_clients"], part["shards_per_client"], seed=part["seed"])
    return [(train.x[i], train.y[i]) for i in split.client_indices]


def make_engine(model_name, data, codec=None, spec_name=None, topology=None,
                device_sampling=False, lr=None, **engine_kw):
    """``RoundEngine`` on the card for ``model_name`` at full size, with the
    fedavg and partition sections of ``specs/<spec_name>.json`` (read as
    JSON; by default the model's own non-IID cell ``<model>_noniid``; ``lr``
    overrides the section's learning rate);
    ``engine_kw`` go to the engine as they are (``latency``,
    ``async_config``, ``pool``, ...). Returns the engine, the model and its
    config."""
    from repro_torch.core.engine import RoundEngine
    from repro_torch.core.fedavg import FedAvgConfig
    from repro_torch.core.simulation import make_eval_fn
    from repro_torch.models import paper
    from repro_torch.utils.tree import tree_leaves

    spec = json.loads((ROOT / "specs" / f"{spec_name or model_name + '_noniid'}.json").read_text())
    fed = spec["fedavg"]
    train, test = data
    clients = noniid_clients(train, spec)
    cfg = FedAvgConfig(C=fed["C"], E=fed["E"], B=fed["B"], lr=fed["lr"] if lr is None else lr,
                       lr_decay=fed["lr_decay"], seed=fed["seed"])
    model = getattr(paper, model_name)(device="cuda")
    params = model.init(fed["seed"])
    n_params = sum(p.numel() for p in tree_leaves(params))
    require(n_params == MAIN_N[model_name], f"{model_name} has {n_params} params")
    eng = RoundEngine(model.loss, params, clients, cfg,
                      eval_fn=make_eval_fn(model.apply, test.x, test.y, device="cuda"),
                      codec=codec, topology=topology, device_sampling=device_sampling,
                      device="cuda", **engine_kw)
    print(f"  {spec['name']}" + ("" if spec["model"]["kind"] == model_name else
                                 f" (its sections, with {model_name})")
          + f": {len(clients)} clients x {len(clients[0][0])} examples, "
          f"C={cfg.C} E={cfg.E} B={cfg.B} lr={cfg.lr}, {n_params} params, "
          f"{eng.packed.max_real_steps_per_epoch * cfg.E} steps/round"
          + (f", codec {codec.name}" if codec is not None else "")
          + (f", topology {topology.name}" if topology is not None else "")
          + (", device sampling" if device_sampling else "")
          + "".join(f", {k}={v!r}" for k, v in engine_kw.items() if k != "pool")
          + f", pool {eng.pool_kind}")
    return eng, model, cfg


def run_lane(name, eng, n_rounds, kernel, runner=None):
    """One lane's main path: every launch count set to 0, ``RoundEngine.run``
    (or ``runner.run``, a ``FederatedTrainer`` over ``eng``), the counts read. ``kernel`` must have launched once a round and every
    other kernel never (``None``: no hand kernel at all). A device-sampling
    engine's rounds are replays, which the wrappers do not count: its
    counters hold the warm-up's eager launch before the capture, and one
    more chunk of ``LANE_PROFILE_R`` replays is profiled after the run
    (``profile_chunk``) to count the replays' launches. Returns the
    launches (the warm-up's and the profiled replays' on that lane), the
    rounds' ``wall_s`` and the chunk's profile (None on the other lanes)."""
    torch.cuda.reset_peak_memory_stats()
    reset_counts()
    graphed = eng.device_sampling
    warmup = int(graphed and eng.num_compilations == 0)
    hist = (runner or eng).run(n_rounds, eval_every=1)
    torch.cuda.synchronize()
    counts = launch_counts()
    for r in hist.records:
        cons = "" if r.consensus is None else f"consensus {r.consensus:.6f} "
        ev = ("not evaluated (inside a chunk) " if r.test_acc is None else
              f"test_acc {r.test_acc:.4f} test_loss {r.test_loss:.6f} ")
        sim = f"sim_s {r.sim_s!r} " if r.sim_s else ""
        print(f"  round {r.round}: loss {r.train_loss:.6f} {cons}{ev}{sim}wall_s {r.wall_s:.4f}")
    if eng.topology is not None and not all(
            math.isfinite(r.consensus) and r.consensus >= 0 for r in hist.records):
        raise AssertionError(f"{name}: bad consensus distances")
    losses = [r.train_loss for r in hist.records]
    if len(hist.records) != n_rounds or not all(math.isfinite(v) for v in losses):
        raise AssertionError(f"{name}: non-finite or missing round losses {losses}")
    accs = [r.test_acc for r in hist.records if r.test_acc is not None]
    if hist.records[-1].test_acc is None or not all(
            math.isfinite(a) and 0.0 <= a <= 1.0 for a in accs):
        raise AssertionError(f"{name}: bad test accuracies {accs}")
    want = {k: ((warmup if graphed else n_rounds) if k == kernel else 0) for k in KERNELS}
    if counts != want:
        raise AssertionError(f"{name}: launches {counts} in {n_rounds} rounds, want {want}")
    require_main_route(name, kernel)
    print(f"  launches counted by the wrappers in the run ({n_rounds} rounds"
          + (f", replays of a captured round; {warmup} the warm-up's before the capture"
             if graphed else "") + "): "
          + ", ".join(f"{k} {v}" for k, v in counts.items())
          + f"; peak device memory {torch.cuda.max_memory_allocated() / 2**20:.0f} MiB")
    walls = [r.wall_s for r in hist.records]
    if graphed:
        prof = profile_chunk(name, eng, kernel, LANE_PROFILE_R)
        return warmup + prof["launches"], walls, prof
    return (counts[kernel] if kernel else 0), walls, None


def route_launches(kernel):
    """Launches of a wire kernel's main route since the counts were reset
    (the codec kernels' stream route, the top-k kernel's fused one), with
    the route's name; None for the other kernels."""
    if kernel in ("quantized_aggregate", "packed_quantized_aggregate"):
        return "stream", counters()[kernel].stream_launches
    if kernel == "sparse_aggregate":
        return "fused", counters()[kernel].fused_launches
    return None


def require_main_route(name, kernel):
    """Every launch of a wire kernel since the counts were reset took its
    main route: the stream route for the codec kernels, the fused route for
    the top-k one."""
    main = route_launches(kernel)
    if main is not None:
        route, n = main
        f = counters()[kernel]
        require(n == f.launches, f"{name}: {n} of {f.launches} {kernel} launches on the "
                                 f"{route} route")
        print(f"  {kernel}: {n} of {f.launches} launches on the {route} route")


def main_path(model_name, data):
    eng, model, cfg = make_engine(model_name, data)
    round_card_vs_cpu(model_name, eng, model.loss, cfg)
    launches, walls, _ = run_lane(model_name, eng, ROUNDS[model_name], "fedavg_aggregate")
    return launches, walls, eng


def round_card_vs_cpu(model_name, eng, loss_fn, cfg, rtol_1=UPDATE_RTOL_1):
    """A round on the card against the same round on the CPU: same params,
    same injected batches (``materialize_round_batch``), short rounds of 1
    step (held to ``rtol_1``) and of CHECK_STEPS steps; returns the two
    updates' relative gaps. A 1-step limit above UPDATE_RTOL_1 must be fp32
    rounding: ``fp64_witness`` holds it to the round in fp64; its readings
    are returned under "to_fp64"."""
    from repro_torch.core.engine import RoundBatch, RoundState, build_simulation_round_step
    from repro_torch.core.fedavg import sample_clients
    from repro_torch.utils.tree import tree_map

    ids = sample_clients(np.random.default_rng(1234), eng.num_clients, cfg.C)
    batch, mask, w = eng.materialize_round_batch(ids, generator_seed=1234)
    step = build_simulation_round_step(loss_fn)
    start = host_vector(eng.params)
    gaps = []
    for n_steps, rtol in ((1, rtol_1), (CHECK_STEPS, UPDATE_RTOL_N)):
        b = tuple(x[:, :n_steps].contiguous() for x in batch)
        msk = mask[:, :n_steps].contiguous()
        gpu_state, gpu_m = step(RoundState(eng.params, ()), RoundBatch(b, msk, w, lr=cfg.lr))
        cpu_state, cpu_m = step(
            RoundState(tree_map(lambda p: p.cpu(), eng.params), ()),
            RoundBatch(tuple(x.cpu() for x in b), msk.cpu(), w, lr=cfg.lr))
        torch.cuda.synchronize()
        d_gpu = host_vector(gpu_state.params) - start
        d_cpu = host_vector(cpu_state.params) - start
        rel = float((d_gpu - d_cpu).norm() / d_cpu.norm())
        l_gpu, l_cpu = float(gpu_m["loss"]), float(cpu_m["loss"])
        l_err = abs(l_gpu - l_cpu) / max(abs(l_cpu), 1e-12)
        ok = rel <= rtol and l_err <= LOSS_RTOL
        print(f"  card vs CPU, a {n_steps}-step round on {len(ids)} clients: update "
              f"|d_card - d_cpu|/|d_cpu| = {rel:.3e} (rtol {rtol:g}; max abs "
              f"{float((d_gpu - d_cpu).abs().max()):.3e}, |d_cpu| = {float(d_cpu.norm()):.3e}), "
              f"loss {l_gpu:.6f} vs {l_cpu:.6f} (rel {l_err:.2e}, rtol {LOSS_RTOL:g}) "
              f"{'ok' if ok else 'FAIL'}")
        if not ok:
            raise AssertionError(
                f"{model_name}: the round on the card disagrees with the CPU round")
        gaps.append(rel)
        if n_steps == 1 and rtol > UPDATE_RTOL_1:
            gaps.append({"to_fp64": fp64_witness(model_name, eng, loss_fn, cfg, b, msk, w,
                                                 start, d_gpu, d_cpu, rtol)})
    return gaps


def fp64_witness(model_name, eng, loss_fn, cfg, b, msk, w, start, d_gpu, d_cpu, rtol):
    """The 1-step round in fp64 on the CPU (d_64) as the witness of a loose
    1-step limit: both fp32 rounds within ``rtol`` of it, the card's fp64
    round within FP64_RTOL (the same function), and the card's fp32 round
    with cuDNN off (PyTorch's own convolutions) within UPDATE_RTOL_1, which
    puts the rest of the card's gap in cuDNN's algorithms. Prints the leaf
    where the card's fp32 round is furthest from d_64; returns the gaps."""
    from repro_torch.core.engine import RoundBatch, RoundState, build_simulation_round_step
    from repro_torch.utils.tree import tree_leaves, tree_paths

    d_64 = star_round_fp64(loss_fn, eng.params, b, msk, w, cfg.lr, "cpu") - start
    d_64_card = star_round_fp64(loss_fn, eng.params, b, msk, w, cfg.lr, "cuda") - start
    with torch.backends.cudnn.flags(enabled=False):
        state, _ = build_simulation_round_step(loss_fn)(RoundState(eng.params, ()),
                                                        RoundBatch(b, msk, w, lr=cfg.lr))
        d_plain = host_vector(state.params) - start
    to64 = {k: float((d - d_64).norm() / d_64.norm())
            for k, d in (("card", d_gpu), ("cpu", d_cpu), ("card_fp64", d_64_card),
                         ("card_without_cudnn", d_plain))}
    sizes = [p.numel() for p in tree_leaves(eng.params)]
    leaf_gaps = [float((g - e).norm() / e.norm())
                 for g, e in zip(d_gpu.split(sizes), d_64.split(sizes))]
    worst = int(np.argmax(leaf_gaps))
    to64["worst_leaf"] = "/".join(map(str, tree_paths(eng.params)[worst]))
    to64["worst_leaf_card"] = leaf_gaps[worst]
    ok = (max(to64["card"], to64["cpu"]) <= rtol and to64["card_fp64"] <= FP64_RTOL
          and to64["card_without_cudnn"] <= UPDATE_RTOL_1)
    print(f"    the same round in fp64 on the CPU (d_64): |d_card - d_64|/|d_64| = "
          f"{to64['card']:.3e}, |d_cpu - d_64|/|d_64| = {to64['cpu']:.3e} (rtol {rtol:g}); "
          f"the card in fp64 {to64['card_fp64']:.3e} (rtol {FP64_RTOL:g}); the card in fp32 "
          f"without cuDNN {to64['card_without_cudnn']:.3e} (rtol {UPDATE_RTOL_1:g}); the card's "
          f"furthest leaf {to64['worst_leaf']} {leaf_gaps[worst]:.3e} {'ok' if ok else 'FAIL'}")
    if not ok:
        raise AssertionError(f"{model_name}: the fp64 witness does not back the 1-step limit")
    return to64


def star_round_fp64(loss_fn, params, batch, mask, weights, lr, device):
    """The global params after one star round computed on ``device`` in fp64
    (the weighted sum of the deltas in plain torch, as the kernel wrapper
    takes only fp32 and bf16; the loss's softmax stays fp32, as the port's
    cross-entropy casts its logits, ~6e-8 relative), as one host vector in
    ``host_vector``'s layout."""
    from repro_torch.core.fedavg import client_update
    from repro_torch.utils.tree import tree_map

    def f64(t):
        return t.detach().to(device).double() if t.is_floating_point() else t.to(device)

    p64 = tree_map(f64, params)
    trained, _ = client_update(loss_fn, p64, tuple(f64(x) for x in batch), f64(mask), lr)
    w = torch.as_tensor(weights).to(device).double()
    w = w / w.sum()
    return host_vector(tree_map(lambda c, p: p + torch.tensordot(w, c - p, dims=1), trained, p64))


def recording(codec, box):
    """``codec`` with its encode and aggregate wrapped to keep the last
    round's payloads, weights and card aggregate in ``box``; the codec's
    own functions do the work."""
    def encode(gen, flat):
        box["payloads"] = codec.encode(gen, flat)
        return box["payloads"]

    def aggregate(payloads, weights, n):
        out = codec.aggregate(payloads, weights, n)
        box.update(weights=weights, n=n, out=out)
        return out

    return codec._replace(encode=encode, aggregate=aggregate)


def compressed_lane(model_name, spec_name, override, kernel, data):
    """The compressed lane through ``RoundEngine(codec=...).run``, then the
    last round's payloads aggregated again on the CPU (plain versions) and
    their realized bytes against the wire-bytes table."""
    from repro_torch.core.compression import decode_aggregate, realized_device_bytes
    from repro_torch.specs import get_spec

    codec = dataclasses.replace(get_spec(spec_name).codec, **override).build()
    print(f"  codec {codec.name} from specs/{spec_name}.json"
          + (f" with {override}" if override else "")
          + f"; aggregate through {kernel or 'an einsum (no hand kernel)'}")
    box = {}
    eng, _, _ = make_engine(model_name, data, codec=recording(codec, box))
    launches, walls, _ = run_lane(f"{model_name} {codec.name}", eng, COMPRESSED_ROUNDS, kernel)

    n = box["n"]
    host = {k: v.cpu() for k, v in box["payloads"].items()}
    card = box["out"].cpu()
    plain = decode_aggregate(codec, host, torch.as_tensor(box["weights"]).cpu(), n)
    if kernel is not None:
        tol = 1e-6 * float(codec.decode(host, n).abs().max())
        err = float((card - plain).abs().max())
        ok = err <= tol
        detail = f"max_abs_err={err:.3e} tol={tol:.3e} (1e-6*max|term|)"
    else:
        err = float((card - plain).norm() / plain.norm())
        ok = err <= LOWRANK_RTOL
        detail = f"|card - cpu|/|cpu|={err:.3e} rtol={LOWRANK_RTOL:g}"
    print(f"  the last round's {card.numel()}-long aggregate, card vs the CPU plain "
          f"versions on the same payloads: {detail} {'ok' if ok else 'FAIL'}")
    if not ok:
        raise AssertionError(f"{model_name} {codec.name}: the card's aggregate disagrees")
    one = {k: v[0] for k, v in host.items()}
    realized = realized_device_bytes(one)
    want = WIRE_BYTES[n][codec.name]
    print(f"  one client's payload: {realized} bytes realized, wire_bytes({n}) = "
          f"{codec.wire_bytes(n)}, table {want}; dense fp32 {4 * n} "
          f"({4 * n / realized:.2f}x)")
    require(realized == codec.wire_bytes(n) == want,
            f"{model_name} {codec.name}: realized bytes {realized}, want {want}")
    main = route_launches(kernel)
    return {"model": model_name, "codec": codec.name, "kernel": kernel,
            "launches": launches, "main_route": main and main[0],
            "main_route_launches": main and main[1],
            "rounds": COMPRESSED_ROUNDS, "round_wall_s": walls,
            "aggregate_err": err, "payload_bytes": realized, "dense_bytes": 4 * n}, eng


def busy_seconds(spans):
    """Length of the union of (start, end) intervals in µs, in seconds:
    the time at least one device op ran, however many ran at once."""
    total, end = 0.0, -math.inf
    for s, e in sorted(spans):
        if e > end:
            total += e - max(s, end)
            end = e
    return total / 1e6


class Span(NamedTuple):
    """A device op's interval, µs from the trace's start."""
    start: float
    end: float

    def elapsed_us(self) -> float:
        return self.end - self.start


class DeviceOp(NamedTuple):
    """One device op of a profile (kernel, copy or fill), with the fields of
    ``prof.events()``'s device events that the phases read."""
    name: str
    time_range: Span
    device_resource_id: int    # the stream


def profiled_device_ops(prof):
    """A finished profile's device ops, from its raw kineto events (a
    ``record_function`` range's span on the device timeline is no op)."""
    return read_trace(prof)[0]


def device_profile(fn):
    """Run ``fn`` once under torch.profiler's CUDA activity (CUPTI): its host
    wall time, which ends when the card has finished, the device ops, and
    (self device µs, count, name) rows by kernel, longest first.

    The ops are read from the profiler's raw kineto events, the ones
    ``prof.events()`` turns into ``FunctionEvent``s and a tree: that
    processing costs the host ~0.3 ms an op, 90 s for the 326,000 ops of one
    profiled CNN ring round (phase 13), and reads no other number."""
    from torch.profiler import ProfilerActivity, profile

    torch.cuda.synchronize()
    with profile(activities=[ProfilerActivity.CUDA]) as prof:
        t0 = time.perf_counter()
        fn()
        torch.cuda.synchronize()
        wall = time.perf_counter() - t0
    ops = profiled_device_ops(prof)
    by_name = {}
    for e in ops:             # a device op's self time is its duration
        us, count = by_name.get(e.name, (0.0, 0))
        by_name[e.name] = (us + e.time_range.elapsed_us(), count + 1)
    rows = sorted(((us, count, name) for name, (us, count) in by_name.items() if us > 0),
                  reverse=True)
    return wall, ops, rows


def profile_round(name, eng, key, label):
    """Device time of one more round by kernel against the round's host wall
    time; ``key`` picks the hand kernel's rows by name. Device busy is the
    union of the device ops' intervals: ops that overlap (on several
    streams) count once, so the sum of the ops' times may exceed it."""
    wrapper = counters()[label]
    launched = wrapper.launches
    wall, ops, rows = device_profile(lambda: float(eng.round()["loss"]))
    launched = wrapper.launches - launched
    busy = busy_seconds((e.time_range.start, e.time_range.end) for e in ops)
    summed = sum(e.time_range.elapsed_us() for e in ops) / 1e6
    streams = len({e.device_resource_id for e in ops})
    mine = [r for r in rows if key in r[2]]
    agg = sum(r[0] for r in mine) / 1e6
    share = (f"{agg * 1e3:.4f} ms ({agg / wall:.4%} of the round, {agg / summed:.4%} of "
             "the ops' summed time)" if mine else
             "not in the profiler's trace")
    print(f"  {name}: round wall {wall:.4f} s under the profiler, device busy {busy:.4f} s "
          f"(idle share {1 - busy / wall:.1%}; the ops' times sum to {summed:.4f} s on "
          f"{streams} streams), {len(ops)} device ops; {label} launched {launched}x by its "
          f"counter, {share}")
    for us, count, k in rows[:8]:
        print(f"    {us / 1e3:10.3f} ms {count:6d}x  {k[:90]}")
    return {"wall_s": wall, "device_busy_s": busy, "idle_share": 1 - busy / wall,
            "device_ops_summed_s": summed, "streams": streams, "device_ops": len(ops),
            "launches": launched, "kernel_ms": agg * 1e3 if mine else None}


def gossip_card_vs_cpu(name, eng, model, cfg, steps):
    """One gossip round of ``steps[i][0]`` steps on the card against the same
    round on the CPU: same replicas, same plan, same injected batches.
    Compared on the replicas' update in L2 relative to its size, on the loss
    and on the consensus distance."""
    from repro_torch.core.engine import build_gossip_round_step
    from repro_torch.utils.tree import tree_map

    batch, mask, w = eng.materialize_round_batch(np.arange(eng.num_clients),
                                                 generator_seed=1234)
    step = build_gossip_round_step(model.loss)
    start = host_vector(eng.params)
    cpu_params = tree_map(lambda p: p.cpu(), eng.params)
    for n_steps, rtol in steps:
        b = tuple(x[:, :n_steps].contiguous() for x in batch)
        msk = mask[:, :n_steps].contiguous()
        gpu_p, gpu_m = step(eng.params, b, msk, w, eng._mix_idx, eng._mix_w, cfg.lr)
        cpu_p, cpu_m = step(cpu_params, tuple(x.cpu() for x in b), msk.cpu(), w,
                            eng._mix_idx.cpu(), eng._mix_w.cpu(), cfg.lr)
        torch.cuda.synchronize()
        d_gpu = host_vector(gpu_p) - start
        d_cpu = host_vector(cpu_p) - start
        rel = float((d_gpu - d_cpu).norm() / d_cpu.norm())
        l_gpu, l_cpu = float(gpu_m["loss"]), float(cpu_m["loss"])
        c_gpu, c_cpu = float(gpu_m["consensus"]), float(cpu_m["consensus"])
        l_err = abs(l_gpu - l_cpu) / max(abs(l_cpu), 1e-12)
        c_err = abs(c_gpu - c_cpu) / max(abs(c_cpu), 1e-12)
        ok = rel <= rtol and l_err <= LOSS_RTOL and c_err <= rtol
        print(f"  card vs CPU, a {n_steps}-step gossip round on {eng.num_clients} nodes: "
              f"update |d_card - d_cpu|/|d_cpu| = {rel:.3e} (rtol {rtol:g}), loss "
              f"{l_gpu:.6f} vs {l_cpu:.6f} (rel {l_err:.2e}, rtol {LOSS_RTOL:g}), consensus "
              f"{c_gpu:.6e} vs {c_cpu:.6e} (rel {c_err:.2e}, rtol {rtol:g}) "
              f"{'ok' if ok else 'FAIL'}")
        if not ok:
            raise AssertionError(f"{name}: the gossip round on the card disagrees with the CPU")
        if n_steps == 1:
            d_64 = gossip_round_fp64(eng, model, b, msk, cfg.lr) - start
            to64 = {k: float((d - d_64).norm() / d_64.norm())
                    for k, d in (("card", d_gpu), ("cpu", d_cpu))}
            ok = max(to64.values()) <= rtol
            print(f"    the same round on the CPU in fp64: |d_card - d_64|/|d_64| = "
                  f"{to64['card']:.3e}, |d_cpu - d_64|/|d_64| = {to64['cpu']:.3e} "
                  f"(rtol {rtol:g}) {'ok' if ok else 'FAIL'}")
            if not ok:
                raise AssertionError(f"{name}: an fp32 gossip round is far from fp64")


def gossip_round_fp64(eng, model, batch, mask, lr):
    """The replicas after one gossip round computed on the CPU in fp64 (the
    plain mix, as the kernel wrapper takes only fp32 and bf16), as one host
    vector in ``host_vector``'s layout."""
    from repro_torch.core.fedavg import client_update_stacked
    from repro_torch.kernels.gossip_mix import gossip_mix_ref
    from repro_torch.utils.tree import tree_map, tree_ravel_stacked, tree_unravel_stacked

    def f64(t):
        return t.cpu().double() if t.is_floating_point() else t.cpu()

    trained, _ = client_update_stacked(model.loss, tree_map(f64, eng.params),
                                       tuple(f64(x) for x in batch), f64(mask), lr)
    flat, spec = tree_ravel_stacked(trained)
    mixed = gossip_mix_ref(flat, eng._mix_idx.cpu(), eng._mix_w.cpu(), torch.float64)
    return host_vector(tree_unravel_stacked(spec, mixed))


def gossip_lane(model_name, spec_name, data):
    """The gossip lane through ``RoundEngine(topology=...).run`` at full size,
    after a card-vs-CPU round on injected batches."""
    from repro_torch.specs import get_spec

    topo = get_spec(spec_name).topology.build()
    eng, model, cfg = make_engine(model_name, data, spec_name=spec_name, topology=topo,
                                  lr=GOSSIP_CNN_LR if model_name == "mnist_cnn" else None)
    require(eng.num_clients == N_NODES and eng.plan.n_nodes == N_NODES,
            f"{spec_name}: {eng.num_clients} nodes")
    print(f"  plan: {eng.plan.n_nodes} nodes x {eng.plan.max_slots} slots, "
          f"{int(np.count_nonzero(eng.plan.weight))} non-zero")
    # the CPU takes seconds a step for 100 CNN nodes: one step there
    steps = ((1, GOSSIP_CNN_RTOL_1),) if model_name == "mnist_cnn" else \
        ((1, UPDATE_RTOL_1), (CHECK_STEPS, UPDATE_RTOL_N))
    gossip_card_vs_cpu(f"{model_name} {topo.kind}", eng, model, cfg, steps)
    launches, walls, _ = run_lane(f"{model_name} {topo.kind}", eng, GOSSIP_ROUNDS, "gossip_mix")
    route, _ = gossip_route_kernel(eng)
    dense = counters()["gossip_mix"].dense_launches
    require(dense == (launches if route == "dense" else 0),
            f"{spec_name}: {dense} of {launches} gossip_mix launches on the dense route, "
            f"want the {route} route")
    print(f"  gossip_mix route: {route} ({dense} dense launches)")
    recs = eng.history.records
    return {"model": model_name, "spec": spec_name, "topology": topo.name,
            "kernel": "gossip_mix", "launches": launches, "route": route,
            "dense_launches": dense, "rounds": GOSSIP_ROUNDS,
            "round_wall_s": walls, "consensus": [r.consensus for r in recs],
            "test_acc": [r.test_acc for r in recs],
            "peak_device_MiB": torch.cuda.max_memory_allocated() / 2**20}, eng


def anchor(data):
    """The full graph is centralized FedAvg: one gossip round on 100 nodes
    against one plain round with C = 1.0, same batches, same start."""
    from repro_torch.core.engine import (
        RoundBatch,
        RoundState,
        build_gossip_round_step,
        build_simulation_round_step,
    )
    from repro_torch.core.topology import FullTopology
    from repro_torch.utils.tree import tree_leaves, tree_map

    eng, model, cfg = make_engine("mnist_2nn", data, spec_name="mnist_2nn_noniid_ring",
                                  topology=FullTopology())
    counts = eng.packed.counts
    require(bool((counts == counts[0]).all()), "the anchor needs equal shards")
    batch, mask, w = eng.materialize_round_batch(np.arange(eng.num_clients),
                                                 generator_seed=4321)
    start = tree_map(lambda p: p[0].clone(), eng.params)   # every replica is the init
    reset_counts()
    mixed, gm = build_gossip_round_step(model.loss)(
        eng.params, batch, mask, w, eng._mix_idx, eng._mix_w, cfg.lr)
    state, sm = build_simulation_round_step(model.loss)(
        RoundState(start, ()), RoundBatch(batch, mask, w, lr=cfg.lr))
    torch.cuda.synchronize()
    n_launched = launch_counts()
    dense = counters()["gossip_mix"].dense_launches
    require(n_launched["gossip_mix"] == 1 and n_launched["fedavg_aggregate"] == 1,
            f"anchor launches {n_launched}")
    require(dense == 1, "the anchor's gossip_mix launch did not take the dense route")
    mean = tree_map(lambda p: p.float().mean(dim=0), mixed)
    err = max(float((a - b.float()).abs().max())
              for a, b in zip(tree_leaves(mean), tree_leaves(state.params)))
    cons = float(gm["consensus"])
    rms = math.sqrt(sum(float((p.float() ** 2).sum()) for p in tree_leaves(mixed))
                    / eng.num_clients)
    l_g, l_s = float(gm["loss"]), float(sm["loss"])
    l_err = abs(l_g - l_s) / abs(l_s)
    ok = (err <= ANCHOR_ATOL and cons <= ANCHOR_CONSENSUS_RTOL * rms
          and l_err <= ANCHOR_LOSS_RTOL)
    print(f"  full graph, {eng.num_clients} nodes, one {mask.shape[1]}-step round: node mean vs "
          f"FedAvg params max_abs_err={err:.3e} (atol {ANCHOR_ATOL:g}); consensus "
          f"{cons:.3e} = {cons / rms:.2e} of the replicas' RMS norm {rms:.3f} (rtol "
          f"{ANCHOR_CONSENSUS_RTOL:g}); loss {l_g:.8f} vs {l_s:.8f} (rel {l_err:.2e}, "
          f"rtol {ANCHOR_LOSS_RTOL:g}); gossip_mix on the dense route "
          f"{'ok' if ok else 'FAIL'}")
    if not ok:
        raise AssertionError("the full-graph gossip round is not the FedAvg round")
    return {"max_abs_err": err, "consensus": cons, "replica_rms_norm": rms,
            "loss_rel_err": l_err, "gossip_mix_route": "dense"}


# ---------------------------------------------------------------------------
# phase 21: the spec front door and checkpoints
# ---------------------------------------------------------------------------

def record_cohorts(eng):
    """Wrap ``eng``'s cohort draw to keep each round's ids; returns the list
    they are appended to."""
    ids = []
    draw = eng._next_round_inputs

    def recorded():
        out = draw()
        ids.append(np.asarray(out[0]).tolist())
        return out

    eng._next_round_inputs = recorded
    return ids


class CharData(NamedTuple):
    """The Shakespeare spec's federated corpus: one client of (n, 80)
    windows a role, and every role's test windows."""

    clients: list
    x_test: np.ndarray
    y_test: np.ndarray


def shakespeare_data():
    """``make_char_corpus`` at its defaults, the spec's 1146 roles, cut into
    windows at ``CHAR_UNROLL``; made once and shared by phases 21 and 23."""
    from repro_torch.data import make_char_corpus, windows_from_sequence
    from repro_torch.specs import get_spec

    t0 = time.perf_counter()
    train, test, V = make_char_corpus()
    spec = get_spec("shakespeare_lstm")
    require(len(train) == spec.partition.n_clients and V == spec.model.kwargs["vocab_size"],
            f"{len(train)} roles and V = {V} for the spec's {spec.partition.n_clients} roles "
            f"and V = {spec.model.kwargs['vocab_size']}")
    clients = [windows_from_sequence(t, CHAR_UNROLL) for t in train]
    tx, ty = zip(*(windows_from_sequence(t, CHAR_UNROLL) for t in test))
    data = CharData(clients, np.concatenate(tx), np.concatenate(ty))
    sizes = np.array([len(x) for x, _ in clients])
    print(f"  make_char_corpus(): {len(train)} roles, {sum(len(t) for t in train):,} train "
          f"chars, V = {V}; {sizes.sum():,} train windows of {CHAR_UNROLL} (a client "
          f"{sizes.min()}..{sizes.max()}), {len(data.x_test):,} test windows; made in "
          f"{time.perf_counter() - t0:.2f} s")
    return data


def spec_clients(spec, train, chars=None):
    """The clients of the partition ``spec`` names, built by the spec; a
    ``natural`` partition's are the corpus's own (``chars``)."""
    if spec.partition.kind == "natural":
        return chars.clients
    split = spec.build_partition(train.y)
    return [(train.x[i], train.y[i]) for i in split.client_indices]


def spec_eval_fn(spec, test, chars=None):
    from repro_torch.core.simulation import make_eval_fn

    x, y = (chars.x_test, chars.y_test) if spec.partition.kind == "natural" else (test.x, test.y)
    return make_eval_fn(spec.build_model(device="cuda").apply, x, y, device="cuda")


def load_specs():
    """Every ``specs/*.json`` through ``repro_torch.specs``: each equals its
    preset and writes back the same JSON."""
    from repro_torch.specs import PAPER_SPECS, ExperimentSpec

    files = sorted((ROOT / "specs").glob("*.json"))
    require({f.stem for f in files} == set(PAPER_SPECS) and len(files) == 15,
            f"specs/ holds {[f.stem for f in files]}, the registry {sorted(PAPER_SPECS)}")
    for f in files:
        spec = ExperimentSpec.from_json(f.read_text())
        require(spec == PAPER_SPECS[f.stem], f"{f.name} differs from its preset")
        require(ExperimentSpec.from_json(spec.to_json()) == spec, f"{f.name} does not round-trip")
    print(f"  {len(files)} specs loaded through repro_torch.specs, each equal to its preset")
    return [f.stem for f in files]


def async_schedule_on_cpu(name, train):
    """The async spec ``name``'s event schedule, run by the port on the CPU
    after the card's lanes: the spec's engine built on the CPU from the same
    partition, its client and apply phases stood in for by zeros of their
    shapes (the schedule reads none of their numbers: it is host numpy, the
    cohort draws, the latency model's stream, the heap; the client phase
    draws nothing from the engine's stream), ``ASYNC_APPLIES`` applies.
    Returns the records' ``[round, sim_s]``, the numpy stream's state and
    the seconds it took."""
    from repro_torch.core.engine import RoundEngine
    from repro_torch.specs import get_spec
    from repro_torch.utils.tree import tree_leaves

    t0 = time.perf_counter()
    spec = get_spec(name)
    eng = RoundEngine.from_spec(spec, spec_clients(spec, train), device="cpu")
    n = sum(p.numel() for p in tree_leaves(eng.params))
    eng._client_phase = lambda ids, seed, lr: (torch.zeros(len(ids), n),
                                               torch.zeros(len(ids)), torch.ones(len(ids)))
    eng._apply_buffer = lambda flat, per_loss, w, stale: torch.zeros(())
    hist = eng.run(ASYNC_APPLIES, eval_every=1)
    return {"records": [[r.round, r.sim_s] for r in hist.records],
            "rng": json.loads(json.dumps(eng.rng.bit_generator.state)),
            "wall_s": time.perf_counter() - t0}


def check_async_schedules(train, spec_lanes):
    """The card's async spec lanes against the same specs' schedules run by
    the port on the CPU (``async_schedule_on_cpu``): every record's round
    and ``sim_s`` must be equal float for float, and so must the numpy
    streams' states after the run."""
    for lane in spec_lanes:
        card = lane["async_schedule"]
        if card is None:
            continue
        name = lane["spec"]
        want = async_schedule_on_cpu(name, train)
        require(card["records"] == want["records"],
                f"{name}: the card's schedule {card['records']} is not the CPU's {want['records']}")
        require(card.pop("rng") == want["rng"], f"{name}: the numpy streams differ after the run")
        sim = [v for _, v in card["records"]]
        card.update(sim_s=sim, cpu_wall_s=want["wall_s"], equal_to_cpu=True)
        print(f"  {name}: sim_s a apply " + ", ".join(repr(v) for v in sim)
              + f" ({sum(sim):.4f} s simulated in all): equal float for float to the same "
              f"spec's schedule of {len(sim)} applies on the CPU, its phases stood in for "
              f"({want['wall_s']:.2f} s there, after the card's lanes), the numpy streams equal")


def spec_lane(name, train, test, chars=None):
    """One runnable spec through ``RoundEngine.from_spec(...).run`` at full
    size: its partition built by the spec (the Shakespeare roles: the
    corpus's), its model initialized from its seed by the port; its lane's
    kernel once a round on its main route. On the char-LSTM the device ops
    of one ClientUpdate step are counted too (``lstm_step_ops``)."""
    from repro_torch.core.engine import RoundEngine
    from repro_torch.specs import get_spec

    spec = get_spec(name)
    kernel = SPEC_KERNELS[name]
    clients = spec_clients(spec, train, chars)
    eng = RoundEngine.from_spec(spec, clients, eval_fn=spec_eval_fn(spec, test, chars))
    steps = eng.packed.max_real_steps_per_epoch * spec.fedavg.E
    print(f"  {name}: {len(clients)} clients ({spec.partition.kind}), C={spec.fedavg.C} "
          f"E={spec.fedavg.E} B={spec.fedavg.B} lr={spec.fedavg.lr}, strategy "
          f"{spec.strategy.name}" + (f", codec {eng.codec.name}" if eng.codec else "")
          + (f", topology {eng.topology.name}" if eng.topology else "")
          + (f", buffered-async K={eng.async_config.buffer_k} of "
             f"{eng.async_config.concurrency or eng._m} in flight under {eng.latency}"
             if eng.async_config else "")
          + f", {steps} masked steps a round, pool {eng._x.nbytes + eng._y.nbytes:,} B"
          + f"; through {kernel or 'no hand kernel (an einsum)'}")
    rounds = SPEC_ROUNDS_OF.get(name, SPEC_ROUNDS)
    launches, walls, _ = run_lane(name, eng, rounds, kernel)
    peak_mib = torch.cuda.max_memory_allocated() / 2**20
    schedule = None if spec.async_spec is None else {
        "records": [[r.round, r.sim_s] for r in eng.history.records],
        "rng": json.loads(json.dumps(eng.rng.bit_generator.state))}
    step_ops = lstm_step_ops(eng, steps) if spec.model.kind == "char_lstm" else None
    if kernel == "gossip_mix":
        dense = counters()["gossip_mix"].dense_launches
        require(dense == 0, f"{name}: {dense} gossip_mix launches on the dense route")
        print(f"  gossip_mix: {launches} launches on the gather route")
    accs = [r.test_acc for r in eng.history.records if r.test_acc is not None]
    print(f"  {name}: seconds a round " + ", ".join(f"{t:.4f}" for t in walls)
          + ", test_acc " + ", ".join(f"{a:.4f}" for a in accs))
    main = route_launches(kernel)
    return {"spec": name, "kernel": kernel, "launches": launches, "rounds": rounds,
            "round_wall_s": walls, "test_acc": accs, "steps_a_round": steps,
            "peak_device_MiB": peak_mib, "client_update_step": step_ops,
            "async_schedule": schedule,
            "main_route": main and main[0],
            "main_route_launches": main and main[1],
            "dense_launches": counters()["gossip_mix"].dense_launches
            if kernel == "gossip_mix" else None}


def host_leaves(tree):
    from repro_torch.utils.tree import tree_leaves

    return [t.detach().cpu() for t in tree_leaves(tree)]


def spec_resume(name, train, test, rtol, ckpt_root):
    """``RESUME_ROUNDS`` uninterrupted rounds against half of them, ``save``,
    ``restore`` into a freshly built engine and the other half: params and
    strategy state bitwise equal (``rtol`` None) or within ``rtol`` of the
    uninterrupted rounds' update in L2, and the cohort ids of the second
    half identical."""
    from repro_torch.core.engine import RoundEngine
    from repro_torch.specs import get_spec

    spec = get_spec(name)
    clients = spec_clients(spec, train)
    ev = spec_eval_fn(spec, test)

    def fresh():
        return RoundEngine.from_spec(spec, clients, eval_fn=ev)

    half = RESUME_ROUNDS // 2
    whole = fresh()
    start = host_leaves(whole.params)
    ids_whole = record_cohorts(whole)
    whole.run(RESUME_ROUNDS)
    first = fresh()
    first.run(half)
    t0 = time.perf_counter()
    path = first.save(ckpt_root / name)
    t_save = time.perf_counter() - t0
    del first
    resumed = fresh()
    t0 = time.perf_counter()
    require(resumed.restore(ckpt_root / name) == half, f"{name}: restored a wrong round")
    t_restore = time.perf_counter() - t0
    ids_resumed = record_cohorts(resumed)
    resumed.run(RESUME_ROUNDS - half)
    torch.cuda.synchronize()
    require(ids_resumed == ids_whole[half:], f"{name}: cohorts {ids_resumed} after the resume, "
                                             f"{ids_whole[half:]} uninterrupted")
    a = host_leaves(whole.params) + host_leaves(whole.outer_state)
    b = host_leaves(resumed.params) + host_leaves(resumed.outer_state)
    require(len(a) == len(b), f"{name}: {len(a)} leaves against {len(b)}")
    differ = sum(not torch.equal(x, y) for x, y in zip(a, b))
    max_abs = max(float((x - y).abs().max()) for x, y in zip(a, b))
    update = math.sqrt(sum(float(((x - s).double() ** 2).sum())
                           for x, s in zip(host_leaves(whole.params), start)))
    diff = math.sqrt(sum(float(((x - y).double() ** 2).sum()) for x, y in zip(a, b)))
    rel = diff / update
    n_state = len(host_leaves(whole.outer_state))
    ok = differ == 0 if rtol is None else rel <= rtol
    print(f"  {name}: {RESUME_ROUNDS} rounds vs {half} + save ({t_save:.3f} s, {path}) + "
          f"restore ({t_restore:.3f} s) + {RESUME_ROUNDS - half}: {len(a)} leaves ({n_state} of "
          f"strategy state), {differ} not bitwise equal, max abs diff {max_abs:.3e}, "
          f"|diff|/|{RESUME_ROUNDS}-round update| {rel:.3e} ("
          + ("bitwise required" if rtol is None else f"rtol {rtol:g}")
          + f"); cohorts after the resume identical: {ids_resumed == ids_whole[half:]} "
          f"{'ok' if ok else 'FAIL'}")
    require(ok, f"{name}: the resumed run is not the uninterrupted run")
    return {"spec": name, "leaves": len(a), "state_leaves": n_state, "not_bitwise": differ,
            "max_abs_diff": max_abs, "rel_diff": rel, "rtol": rtol, "save_s": t_save,
            "restore_s": t_restore, "cohorts_equal": True}


def lm_checkpoint(ckpt_root):
    """``launch.train --checkpoint-dir`` on a reduced Gemma-2B in
    bf16 on the card: the checkpoint read back through
    ``repro_torch.checkpoint`` is bitwise the params ``run`` returned."""
    from repro_torch.checkpoint import peek_metadata, restore_checkpoint
    from repro_torch.launch import train

    d = ckpt_root / "lm"
    records, final = train.run(LM_CKPT_ARGV + ["--checkpoint-dir", str(d)])
    back, meta = restore_checkpoint(d, final)
    a, b = host_leaves(final), host_leaves(back)
    require(all(t.dtype == torch.bfloat16 for t in a), "the reduced LM is not in bf16")
    equal = len(a) == len(b) and all(
        x.dtype == y.dtype and torch.equal(x.view(torch.int16), y.view(torch.int16))
        for x, y in zip(a, b))
    require(meta == peek_metadata(d) == {"algo": "fedavg", "arch": "gemma-2b"},
            f"checkpoint metadata {meta}")
    n_bytes = sum(t.numel() * 2 for t in a)
    print(f"  launch.train {' '.join(LM_CKPT_ARGV)} --checkpoint-dir: {len(records)} rounds, "
          f"loss {records[-1]['loss']:.4f}; {len(a)} bf16 leaves ({n_bytes / 2**20:.1f} MiB) "
          f"read back bitwise: {equal} {'ok' if equal else 'FAIL'}")
    require(equal, "the LM checkpoint does not read back bitwise")
    return {"argv": LM_CKPT_ARGV, "leaves": len(a), "bytes": n_bytes, "bitwise": equal,
            "rounds": len(records)}


def lstm_step_ops(eng, steps):
    """Device ops of one ClientUpdate step of ``eng``'s char-LSTM at its
    round's shape, counted by torch.profiler: one vmapped
    ``grad_and_value`` over a whole cohort on the first step of its
    batches, called alone after a warm-up (a whole round, ~1-2 M ops, would
    swamp CUPTI's buffers). Only what was measured goes into the result;
    the count times the round's ``steps`` is printed as worked out, not
    measured, and it is a floor: the SGD apply, the step mask and the
    aggregate add launches of their own."""
    from torch.func import grad_and_value, vmap

    from repro_torch.core.fedavg import sample_clients
    from repro_torch.utils.tree import tree_map

    ids = sample_clients(np.random.default_rng(1234), eng.num_clients, eng.cfg.C)
    batch, _, _ = eng.materialize_round_batch(ids, generator_seed=1234)
    first = tuple(b[:, 0].contiguous() for b in batch)
    stacked = tree_map(lambda p: p.unsqueeze(0).expand((len(ids),) + tuple(p.shape)).clone(),
                       eng.params)
    step = vmap(grad_and_value(eng.loss_fn, has_aux=True))
    step(stacked, first)
    wall, ops, rows = device_profile(lambda: step(stacked, first))
    out = {"device_ops": len(ops), "wall_s_profiled": wall,
           "busy_s": busy_seconds([(e.time_range.start, e.time_range.end) for e in ops]),
           "steps_a_round": steps}
    print(f"  one ClientUpdate step ({len(ids)} clients x {tuple(first[0].shape[1:])} tokens, "
          f"vmap(grad_and_value), profiled alone): {len(ops)} device ops, "
          f"{wall * 1e3:.2f} ms wall, {out['busy_s'] * 1e3:.3f} ms busy; x {steps} steps = "
          f"{len(ops) * steps:,} ops a round (worked out, not measured, a floor: without the "
          f"SGD apply, the step mask and the aggregate); top: "
          + "; ".join(f"{n} x{c} {us / 1e3:.3f} ms" for us, c, n in rows[:4]))
    return out


def spec_front_door(train, test, chars):
    """Phase 21: load the 15 specs and run each, the resumes, the LM
    checkpoint. Checkpoints go to a directory under ``build/``, removed
    after."""
    import shutil
    import tempfile

    spec_names = load_specs()
    require(set(spec_names) == set(SPEC_KERNELS), f"specs {spec_names}, lanes {sorted(SPEC_KERNELS)}")
    spec_lanes = [spec_lane(name, train, test, chars) for name in spec_names]
    check_async_schedules(train, spec_lanes)
    require(len(spec_lanes) == 15, f"{len(spec_lanes)} specs run")
    (ROOT / "build").mkdir(exist_ok=True)
    ckpt_root = Path(tempfile.mkdtemp(prefix="chip_smoke_ckpt_", dir=ROOT / "build"))
    try:
        resumes = [spec_resume(name, train, test, rtol, ckpt_root) for name, rtol in RESUME_SPECS]
        lm_ckpt = lm_checkpoint(ckpt_root)
    finally:
        shutil.rmtree(ckpt_root)
    free_card()
    for lane in spec_lanes:
        print(f"  {lane['spec']:28s} {lane['kernel'] or 'no hand kernel':20s} "
              f"{lane['launches']} launches in {lane['rounds']} rounds; seconds a round "
              + ", ".join(f"{t:.4f}" for t in lane["round_wall_s"])
              + f"; test_acc {lane['test_acc'][-1]:.4f}")
    return spec_lanes, resumes, lm_ckpt


# ---------------------------------------------------------------------------
# phase 22: the superstep lane
# ---------------------------------------------------------------------------

def stream_states(eng):
    """The engine's generator states (the device one, the ids one), to put
    back with ``set_stream_states``."""
    return [None if g is None else g.get_state() for g in (eng._gen, eng._ids_gen)]


def set_stream_states(eng, states):
    for g, st in zip((eng._gen, eng._ids_gen), states):
        if g is not None:
            g.set_state(st)


def eager_round(eng):
    """One eager round of ``eng``'s lane from its state, on clones of its
    params: its next round's inputs drawn (cohort ids, learning rate), the
    round body run outside any graph. Advances the engine's streams, never
    its params: (params, outer_state, metrics)."""
    from repro_torch.core.graphs import run_eager
    from repro_torch.utils.tree import tree_map

    return run_eager(eng._round_body, tree_map(torch.clone, eng.params),
                     tree_map(torch.clone, eng.outer_state), eng._chunk_inputs(1))


def captured_vs_eager(name, eng, kernel, check):
    """One eager device-sampling round on clones of the params, then the
    generators put back and ``round()``: the first call warms up, captures
    and replays. ``check`` is "bitwise" or "rtol" (within ``CAPTURE_RTOL``
    of the update), or "report": the CNN under cuDNN's default,
    nondeterministic backward, whose 300 SGD steps carry an ulp's
    difference far (two eager rounds differ as much), so the gap is printed
    beside a second eager round's and not held. Prints the capture's
    seconds, the graph count and the peak memory."""
    state = stream_states(eng)
    start = host_vector(eng.params)

    def eager():
        set_stream_states(eng, state)
        p, _, (loss,) = eager_round(eng)
        return host_vector(p) - start, float(loss[0])

    d_eager, loss_eager = eager()
    spread = None
    if check == "report":
        d_again, _ = eager()
        spread = float((d_again - d_eager).norm() / d_eager.norm())
    set_stream_states(eng, state)
    gc.collect()
    torch.cuda.empty_cache()
    torch.cuda.reset_peak_memory_stats()
    reset_counts()
    loss = float(eng.round()["loss"])
    torch.cuda.synchronize()
    peak = torch.cuda.max_memory_allocated() / 2**20
    counts = {k: v for k, v in launch_counts().items() if v}
    require(counts == {kernel: 1}, f"{name}: the wrappers counted {counts} in the warm-up, "
                                   f"capture and first replay, want {{{kernel!r}: 1}}")
    require_main_route(f"{name} warm-up", kernel)
    d_cap = host_vector(eng.params) - start
    rel = float((d_cap - d_eager).norm() / d_eager.norm())
    same = bool(torch.equal(d_cap, d_eager)) and loss == loss_eager
    if check == "bitwise":
        ok, held = same, "bitwise required"
    elif check == "rtol":
        ok, held = rel <= CAPTURE_RTOL, f"rtol {CAPTURE_RTOL:g}"
    else:
        ok, held = True, f"not held: a second eager round differs by {spread:.3e}"
    g = eng._graph
    print(f"  {name}: warm-up {g.warmup_s:.3f} s, capture and instantiation {g.capture_s:.3f} s, "
          f"{eng.num_compilations} graph, peak device memory {peak:.0f} MiB (the warm-up's "
          f"eager round and the graph's pool); the wrappers counted {counts}: the warm-up's "
          "eager launch (a capture records launches, a replay runs without the wrappers)")
    print(f"  {name}: captured round vs eager round from the same generator state: update "
          f"|d_cap - d_eager|/|d_eager| = {rel:.3e}, loss {loss:.6f} vs {loss_eager:.6f}, "
          f"bitwise {same} ({held}) {'ok' if ok else 'FAIL'}")
    require(ok, f"{name}: the captured round disagrees with the eager round")
    return {"warmup_s": g.warmup_s, "capture_s": g.capture_s, "graphs": eng.num_compilations,
            "peak_MiB": peak, "bitwise": same, "rel_diff": rel, "eager_spread": spread,
            "warmup_launches": counts[kernel]}


def deterministic_capture_check(model_name, data):
    """The CNN's captured round against its eager round with
    ``torch.backends.cudnn.deterministic`` on: both bitwise equal, on an
    engine of its own (the timed lane keeps cuDNN's default)."""
    torch.backends.cudnn.deterministic = True
    try:
        chk, _, _ = make_engine(model_name, data, device_sampling=True)
        res = captured_vs_eager(f"{model_name} plain, cudnn.deterministic", chk,
                                "fedavg_aggregate", "bitwise")
    finally:
        torch.backends.cudnn.deterministic = False
    del chk
    free_card()
    return res


def superstep_turns(name, host, eng, model_name):
    """Host-sampled rounds and superstep chunks in turns (SUPERSTEP_TURNS):
    seconds a round from ``wall_s``. The wrappers must
    count nothing in a chunk: its rounds are replays, and a round that fell
    back to eager would count its launch (the replays' own launches are
    counted by ``profile_chunk``)."""
    n_host = SUPERSTEP_HOST_ROUNDS[model_name]
    turns = []
    for which in SUPERSTEP_TURNS:
        reset_counts()
        if which == "host":
            recs = host.run(n_host).records[-n_host:]
        else:
            R = SUPERSTEP_TURN_R.get(model_name, SUPERSTEP_R)
            recs = eng.run(R, rounds_per_step=R).records[-R:]
            torch.cuda.synchronize()
            counts = {k: v for k, v in launch_counts().items() if v}
            require(not counts, f"{name}: the wrappers counted {counts} in a chunk of replays")
        walls = [r.wall_s for r in recs]
        require(all(math.isfinite(r.train_loss) for r in recs), f"{name}: non-finite losses")
        turns.append((which, sum(walls) / len(walls)))
        print(f"  {name} {which:9s}: {len(recs):2d} rounds, {turns[-1][1]:.4f} s a round, "
              f"last loss {recs[-1].train_loss:.6f}, test_acc {recs[-1].test_acc:.4f}")
    host_s = [t for w, t in turns if w == "host"]
    step_s = [t for w, t in turns if w == "superstep"]
    print(f"  {name}: host-sampled " + " / ".join(f"{t:.4f}" for t in host_s)
          + " s a round, superstep " + " / ".join(f"{t:.4f}" for t in step_s)
          + f" s a round ({min(host_s) / max(step_s):.1f}x to {max(host_s) / min(step_s):.1f}x);"
          " the wrappers counted no launch in the chunks")
    before = eng.round_idx
    eng.run(5, rounds_per_step=4)        # a chunk of 4 and a ragged 1
    require(eng.num_compilations == 1 and eng.round_idx == before + 5,
            f"{name}: {eng.num_compilations} graphs after a ragged chunk")
    print(f"  {name}: after {len(step_s)} chunk(s) of "
          f"{SUPERSTEP_TURN_R.get(model_name, SUPERSTEP_R)} and a ragged chunk (4 + 1): "
          f"{eng.num_compilations} graph ok")
    return {"turns": turns}


def replays_vs_rounds(name, model_name, codec, data):
    """superstep(20) == 20 x round() on the top-k lane, from two engines
    built alike: every round's loss, the final params and the generator
    states, held as ``TOPK_REPLAY_*`` says."""
    a, _, _ = make_engine(model_name, data, codec=codec, device_sampling=True)
    b, _, _ = make_engine(model_name, data, codec=codec, device_sampling=True)
    start = host_vector(a.params)
    la = [r.train_loss for r in a.run(SUPERSTEP_R, rounds_per_step=SUPERSTEP_R).records]
    lb = torch.stack([b.round()["loss"] for _ in range(SUPERSTEP_R)]).cpu().tolist()
    pa, pb = host_vector(a.params), host_vector(b.params)
    loss_rel = max(abs(x - y) / abs(y) for x, y in zip(la, lb))
    worst = max(range(SUPERSTEP_R), key=lambda j: abs(la[j] - lb[j]) / abs(lb[j]))
    rel = float((pa - pb).norm() / (pb - start).norm())
    gens = torch.equal(a._gen.get_state(), b._gen.get_state())
    ok = (loss_rel <= TOPK_REPLAY_LOSS_RTOL and rel <= TOPK_REPLAY_RTOL and gens
          and all(math.isfinite(x) for x in la))
    print(f"  {name}: superstep({SUPERSTEP_R}) vs {SUPERSTEP_R} x round(): losses within "
          f"{loss_rel:.3e} of each other (round {worst + 1} the farthest; rtol "
          f"{TOPK_REPLAY_LOSS_RTOL:g}), first round {abs(la[0] - lb[0]) / abs(lb[0]):.3e}; "
          f"final params |a - b| / |update| = {rel:.3e} (rtol {TOPK_REPLAY_RTOL:g}); "
          f"generator states equal {gens} {'ok' if ok else 'FAIL'}")
    require(ok, f"{name}: superstep({SUPERSTEP_R}) disagrees with {SUPERSTEP_R} x round()")
    return {"loss_max_rel_diff": loss_rel, "params_rel_diff": rel, "generators_equal": gens}


def superstep_guards_and_resume(name, eng, model_name, data, ckpt_root):
    """The 2NN plain lane's card checks: a warm chunk under
    ``transfer_guard`` and ``retrace_guard`` raises nothing; a sync inside
    the round raises there (before any capture); a fresh engine restored
    from ``save`` replays 20 ``round()`` calls bitwise equal to the saved
    engine's chunk of 20 (params, losses, generator state)."""
    from repro_torch.analysis import retrace_guard, transfer_guard
    from repro_torch.core.engine import RoundEngine
    from repro_torch.core.fedavg import FedAvgConfig
    from repro_torch.core.strategies import FedAvg
    from repro_torch.models import paper

    with transfer_guard():
        with retrace_guard(lambda: eng.num_compilations, what=name):
            eng.run(SUPERSTEP_R, rounds_per_step=SUPERSTEP_R)
    print(f"  {name}: a warm chunk of {SUPERSTEP_R} under transfer_guard() and retrace_guard(): "
          "no sync, no new graph ok")

    class SyncingFedAvg(FedAvg):
        def apply(self, opt_state, params, agg_delta):
            float(agg_delta["out"]["b"].sum())         # a sync inside the round
            return super().apply(opt_state, params, agg_delta)

    model = paper.mnist_2nn(device="cuda")
    r = np.random.default_rng(0)
    clients = [(r.normal(size=(20, 784)).astype(np.float32),
                r.integers(0, 10, 20).astype(np.int32)) for _ in range(10)]
    bad = RoundEngine(model.loss, model.init(0), clients,
                      FedAvgConfig(C=0.5, E=1, B=10, lr=0.1, seed=0),
                      strategy=SyncingFedAvg(), device_sampling=True, device="cuda")
    try:
        with transfer_guard():
            bad.run(1)
    except RuntimeError as e:
        require("synchroniz" in str(e), f"{name}: an unexpected error {e}")
        print(f"  {name}: a .item() inside the round under transfer_guard(): raised "
              f"({str(e).splitlines()[0][:80]}), {bad.num_compilations} graphs ok")
    else:
        raise AssertionError(f"{name}: a sync inside the round did not raise")
    del bad

    path = eng.save(ckpt_root / "superstep")
    whole = eng.run(SUPERSTEP_R, rounds_per_step=SUPERSTEP_R).records[-SUPERSTEP_R:]
    fresh, _, _ = make_engine(model_name, data, device_sampling=True)
    require(fresh.restore(ckpt_root / "superstep") == eng.round_idx - SUPERSTEP_R,
            f"{name}: restored a wrong round")
    losses = torch.stack([fresh.round()["loss"] for _ in range(SUPERSTEP_R)]).cpu().tolist()
    torch.cuda.synchronize()
    a, b = host_leaves(eng.params), host_leaves(fresh.params)
    differ = sum(not torch.equal(x, y) for x, y in zip(a, b))
    ok = (differ == 0 and losses == [r.train_loss for r in whole]
          and torch.equal(eng._gen.get_state(), fresh._gen.get_state()))
    print(f"  {name}: save ({path}) + restore into a fresh engine + {SUPERSTEP_R} x round() "
          f"against the saved engine's chunk of {SUPERSTEP_R}: {len(a)} leaves, {differ} not "
          f"bitwise equal, losses equal {losses == [r.train_loss for r in whole]}, generator "
          f"states equal {torch.equal(eng._gen.get_state(), fresh._gen.get_state())} "
          f"{'ok' if ok else 'FAIL'}")
    require(ok, f"{name}: superstep(20) != 20 x round() after a resume")
    return {"guarded_chunk": True, "sync_raised": True, "resume_bitwise": True}


def profile_chunk(name, eng, kernel, r, main=None):
    """One superstep chunk of r rounds under torch.profiler: its host wall,
    device busy (the union of the ops' intervals), idle share and device
    ops. The profile must hold device ops, and among the hand kernels only
    the lane's main-route kernel, r records, one a replay; the wrappers must
    count nothing. CUPTI on the card sometimes loses a block of records,
    the kernel's among them: a chunk short of the kernel's records is
    profiled again (up to ``PROFILE_ATTEMPTS`` chunks in all), and a short
    chunk passes only if it also lacks other device ops of the complete
    one, so a replay that skipped the kernel fails. Every chunk is printed;
    the launches returned are the records of all of them. ``main``: the
    kernel's name in the records, by default ``MAIN_ROUTE_KERNEL``'s (the
    gossip lanes name their route's)."""
    main = main or MAIN_ROUTE_KERNEL[kernel]
    tries = []
    for _ in range(PROFILE_ATTEMPTS):
        reset_counts()
        wall, ops, rows = device_profile(lambda: eng._superstep(r))
        records = kernel_records(ops)
        counts = {k: v for k, v in launch_counts().items() if v}
        busy = busy_seconds((e.time_range.start, e.time_range.end) for e in ops)
        tries.append({"rounds": r, "wall_s": wall, "device_busy_s": busy,
                      "idle_share": 1 - busy / wall if ops else None, "device_ops": len(ops),
                      "kernel_records": records})
        print(f"  {name}: a chunk of {r} rounds under the profiler: wall {wall:.4f} s "
              f"({wall / r:.4f} s a round), device busy {busy:.4f} s (idle share "
              f"{1 - busy / wall:.1%}), {len(ops)} device ops ({len(ops) / r:.0f} a round); "
              f"hand kernels in the records {records}")
        require(ops, f"{name}: the profiler saw no device op in a chunk of {r} replays")
        require(not counts, f"{name}: the wrappers counted {counts} in a chunk of replays")
        require(set(records) <= {main} and records.get(main, 0) <= r,
                f"{name}: hand kernels in the profiler's records of a chunk of {r} replays "
                f"{records}, want only {main}, once a replay")
        if records.get(main, 0) == r:
            break
    else:
        raise AssertionError(f"{name}: {PROFILE_ATTEMPTS} profiled chunks of {r} replays, none "
                             f"with {r} {main} records")
    complete = tries[-1]["device_ops"]
    require(all(t["device_ops"] + r - t["kernel_records"].get(main, 0) < complete
                for t in tries[:-1]),
            f"{name}: a chunk lacked {main} records but no other device op of the complete "
            "chunk")
    if len(tries) > 1:
        print(f"  {name}: {len(tries) - 1} chunk(s) short of {main} records and of device ops "
              f"({', '.join(str(t['device_ops']) for t in tries[:-1])} against {complete}): "
              "records lost by the profiler")
    for us, count, k in rows[:5]:
        print(f"    {us / 1e3:10.3f} ms {count:6d}x  {k[:90]}")
    print(f"  {name}: {main} once a replay in the profiler's records")
    return {**tries[-1], "attempts": tries,
            "launches": sum(t["kernel_records"].get(main, 0) for t in tries)}


def superstep_spec(train, test):
    """``mnist_2nn_iid_superstep`` through ``RoundEngine.from_spec``: one
    run of 20 rounds at the spec's R = 20, one chunk, then ``run_lane``'s
    profiled chunk."""
    from repro_torch.core.engine import RoundEngine
    from repro_torch.specs import get_spec

    spec = get_spec("mnist_2nn_iid_superstep")
    eng = RoundEngine.from_spec(spec, spec_clients(spec, train), eval_fn=spec_eval_fn(spec, test))
    require(eng.device_sampling and eng.default_rounds_per_step == SUPERSTEP_R,
            "the superstep spec did not build a device-sampling engine at R = 20")
    launches, walls, prof = run_lane(spec.name, eng, SUPERSTEP_R, "fedavg_aggregate")
    print(f"  {spec.name}: {SUPERSTEP_R} rounds in one chunk, {walls[0]:.4f} s a round "
          f"(capture included), {eng.num_compilations} graph, test_acc "
          f"{eng.history.records[-1].test_acc:.4f}")
    return {"spec": spec.name, "launches": launches, "rounds": SUPERSTEP_R,
            "round_wall_s": walls[0], "test_acc": eng.history.records[-1].test_acc,
            "profile": prof}


def superstep_phase(train, test):
    """Phase 22 (module docstring)."""
    import shutil
    import tempfile

    from repro_torch.specs import get_spec

    lanes = []
    (ROOT / "build").mkdir(exist_ok=True)
    ckpt_root = Path(tempfile.mkdtemp(prefix="chip_smoke_superstep_", dir=ROOT / "build"))
    try:
        for model_name, spec_name, kernel in SUPERSTEP_LANES:
            codec = get_spec(spec_name).codec.build() if spec_name else None
            name = f"{model_name} {codec.name if codec else 'plain'}"
            host, _, _ = make_engine(model_name, (train, test), codec=codec)
            eng, _, _ = make_engine(model_name, (train, test), codec=codec, device_sampling=True)
            check = ("report" if model_name == "mnist_cnn" else
                     "rtol" if kernel == "sparse_aggregate" else "bitwise")
            lane = {"lane": name, "kernel": kernel}
            if model_name == "mnist_cnn":
                lane["deterministic"] = deterministic_capture_check(model_name, (train, test))
            lane.update(**captured_vs_eager(name, eng, kernel, check),
                        **superstep_turns(name, host, eng, model_name))
            if name == "mnist_2nn plain":
                lane.update(superstep_guards_and_resume(name, eng, model_name, (train, test),
                                                        ckpt_root))
            lane["profile"] = profile_chunk(name, eng, kernel, SUPERSTEP_PROFILE_R[model_name])
            lane["launches"] = lane["warmup_launches"] + lane["profile"]["launches"]
            del host, eng
            free_card()
            if kernel == "sparse_aggregate":
                lane["replays_vs_rounds"] = replays_vs_rounds(name, model_name, codec,
                                                              (train, test))
                free_card()
            lanes.append(lane)
    finally:
        shutil.rmtree(ckpt_root)
    spec = superstep_spec(train, test)
    free_card()
    for lane in lanes:
        host_s = " / ".join(f"{t:.4f}" for w, t in lane["turns"] if w == "host")
        step_s = " / ".join(f"{t:.4f}" for w, t in lane["turns"] if w == "superstep")
        print(f"  {lane['lane']:18s} host {host_s} s, superstep {step_s} s "
              f"a round; capture {lane['capture_s']:.3f} s; peak {lane['peak_MiB']:.0f} MiB; "
              f"idle {lane['profile']['idle_share']:.1%} of a profiled chunk")
    return lanes, spec


# ---------------------------------------------------------------------------
# phase 23: the paper's other models
# ---------------------------------------------------------------------------

def cifar_lane():
    """The CIFAR CNN through ``FederatedTrainer`` at the paper's CIFAR split,
    one round; returns the lane's record and its clients."""
    from repro_torch.core import FedAvgConfig, FederatedTrainer, make_eval_fn
    from repro_torch.data import make_image_classification, partition_iid
    from repro_torch.models import paper
    from repro_torch.utils.tree import tree_leaves

    t0 = time.perf_counter()
    d = dict(CIFAR_DATA)
    train, test, _ = make_image_classification(d.pop("n_train"), d.pop("n_test"), **d)
    split = partition_iid(len(train), CIFAR_CLIENTS, seed=0)
    clients = [(train.x[i], train.y[i]) for i in split.client_indices]
    made = time.perf_counter() - t0
    model = paper.cifar_cnn(device="cuda")
    params = model.init(CIFAR_CFG["seed"])
    n_params = sum(p.numel() for p in tree_leaves(params))
    require(n_params == 1_068_298, f"cifar_cnn has {n_params} params")
    cfg = FedAvgConfig(**CIFAR_CFG)
    tr = FederatedTrainer(model.loss, params, clients, cfg,
                          eval_fn=make_eval_fn(model.apply, test.x, test.y, device="cuda"),
                          device="cuda")
    steps = tr.engine.packed.max_real_steps_per_epoch * cfg.E
    print(f"  cifar_cnn: {len(clients)} IID clients x {len(clients[0][0])} crops "
          f"{train.x.shape[1:]} (made in {made:.2f} s), C={cfg.C} E={cfg.E} B={cfg.B} "
          f"lr={cfg.lr}, {n_params:,} params, {steps} steps a round, through FederatedTrainer")
    launches, walls, _ = run_lane("cifar_cnn", tr.engine, 1, "fedavg_aggregate", runner=tr)
    acc = tr.history.records[-1].test_acc
    return {"model": "cifar_cnn", "entry": "FederatedTrainer", "launches": launches,
            "rounds": 1, "round_wall_s": walls, "test_acc": acc, "steps_a_round": steps,
            "peak_device_MiB": torch.cuda.max_memory_allocated() / 2**20}, (clients, cfg)


def word_data():
    """``make_word_corpus`` at its defaults, cut into windows of WORD_UNROLL."""
    from repro_torch.data import make_word_corpus, windows_from_sequence

    t0 = time.perf_counter()
    train, test, V = make_word_corpus()
    clients = [windows_from_sequence(t, WORD_UNROLL) for t in train]
    tx, ty = zip(*(windows_from_sequence(t, WORD_UNROLL) for t in test))
    sizes = np.array([len(x) for x, _ in clients])
    print(f"  make_word_corpus(): {len(train)} authors, V = {V}, {sizes.sum():,} train "
          f"windows of {WORD_UNROLL} (a client {sizes.min()}..{sizes.max()}), "
          f"{sum(len(x) for x in tx):,} test windows; made in {time.perf_counter() - t0:.2f} s")
    return clients, np.concatenate(tx), np.concatenate(ty), V


def word_lane(words):
    """The word-LSTM through ``RoundEngine``, one round."""
    from repro_torch.core import FedAvgConfig, RoundEngine, make_eval_fn
    from repro_torch.models import paper
    from repro_torch.utils.tree import tree_leaves

    clients, x_test, y_test, V = words
    model = paper.word_lstm(V, device="cuda")
    params = model.init(WORD_CFG["seed"])
    n_params = sum(p.numel() for p in tree_leaves(params))
    require(n_params == 4_359_120, f"word_lstm has {n_params} params")
    cfg = FedAvgConfig(**WORD_CFG)
    eng = RoundEngine(model.loss, params, clients, cfg,
                      eval_fn=make_eval_fn(model.apply, x_test, y_test, device="cuda"),
                      device="cuda")
    steps = eng.packed.max_real_steps_per_epoch * cfg.E
    print(f"  word_lstm: {len(clients)} clients, C={cfg.C} E={cfg.E} B={cfg.B} lr={cfg.lr}, "
          f"{n_params:,} params, {steps} steps a round, through RoundEngine")
    launches, walls, _ = run_lane("word_lstm", eng, 1, "fedavg_aggregate")
    return {"model": "word_lstm", "entry": "RoundEngine", "launches": launches, "rounds": 1,
            "round_wall_s": walls, "test_acc": eng.history.records[-1].test_acc,
            "steps_a_round": steps,
            "peak_device_MiB": torch.cuda.max_memory_allocated() / 2**20}


def shakespeare_example():
    """``python -m repro_torch.examples.shakespeare_lstm`` as a user runs it,
    on the card, in a process of its own (the kernels' build is cached)."""
    import os

    t0 = time.perf_counter()
    env = {**os.environ, "PYTHONPATH": str(ROOT / "src")}
    res = subprocess.run([sys.executable] + EXAMPLE_ARGV, cwd=ROOT, env=env,
                         capture_output=True, text=True, timeout=600)
    wall = time.perf_counter() - t0
    for line in res.stdout.strip().splitlines()[-4:]:
        print(f"    | {line}")
    if res.returncode != 0:
        print(res.stderr[-3000:])
    rounds = [line for line in res.stdout.splitlines() if line.startswith("round ")]
    require(res.returncode == 0 and len(rounds) == EXAMPLE_ROUNDS,
            f"the example exited {res.returncode} after {len(rounds)} rounds")
    print(f"  python {' '.join(EXAMPLE_ARGV)}: exit 0, {len(rounds)} rounds, {wall:.2f} s "
          "wall (its start, corpus and rounds)")
    return {"argv": EXAMPLE_ARGV, "returncode": res.returncode, "wall_s": wall,
            "rounds": rounds}


def paper_models_card_vs_cpu(chars, cifar, words):
    """Each model at its full width on a reduced population: a round on the
    card against the same round on the CPU (``round_card_vs_cpu``)."""
    from repro_torch.core import FedAvgConfig, RoundEngine
    from repro_torch.models import paper
    from repro_torch.specs import get_spec

    spec = get_spec("shakespeare_lstm")
    char = spec.build_model(device="cuda")
    cifar_model = paper.cifar_cnn(device="cuda")
    word = paper.word_lstm(words[3], device="cuda")
    cases = (("char_lstm", char, chars.clients, spec.fedavg),
             ("cifar_cnn", cifar_model, cifar[0], cifar[1]),
             ("word_lstm", word, words[0], FedAvgConfig(**WORD_CFG)))
    gaps = {}
    for name, model, clients, cfg in cases:
        eng = RoundEngine(model.loss, model.init(0), clients[:REDUCED_CLIENTS],
                          dataclasses.replace(cfg, C=REDUCED_C), device="cuda")
        print(f"  {name}: {eng.num_clients} clients, C={REDUCED_C}")
        gaps[name] = round_card_vs_cpu(name, eng, model.loss, eng.cfg, PAPER_RTOL_1[name])
        del eng
    return gaps


def paper_models_phase(chars):
    """Phase 23: the CIFAR CNN through FederatedTrainer and the word-LSTM
    through RoundEngine, one round each at full size; the Shakespeare
    example in its own process; card vs CPU for the three models."""
    cifar, cifar_clients = cifar_lane()
    free_card()
    words = word_data()
    word = word_lane(words)
    free_card()
    example = shakespeare_example()
    gaps = paper_models_card_vs_cpu(chars, cifar_clients, words)
    free_card()
    return {"cifar_cnn": cifar, "word_lstm": word, "example": example,
            "card_vs_cpu_update_rtol": gaps}


# ---------------------------------------------------------------------------
# phase 24: the buffered-async lane and the streamed pool
# ---------------------------------------------------------------------------

def leaves_equal(a, b):
    from repro_torch.utils.tree import tree_leaves

    la, lb = tree_leaves(a), tree_leaves(b)
    return len(la) == len(lb) and all(torch.equal(x, y) for x, y in zip(la, lb))


def rss_mb() -> float:
    """This process's resident set (VmRSS) in MB."""
    for line in Path("/proc/self/status").read_text().splitlines():
        if line.startswith("VmRSS:"):
            return int(line.split()[1]) / 1024.0
    raise AssertionError("no VmRSS in /proc/self/status")


def synth_clients(K, n_per, d, seed=0):
    """K equal synthetic clients, one at a time (``benchmarks/round_engine.py``
    ``_synth_clients``): the population never exists in host RAM at once."""
    rng = np.random.default_rng(seed)
    for _ in range(K):
        yield (rng.standard_normal((n_per, d), dtype=np.float32) * 0.1,
               rng.integers(0, 5, n_per).astype(np.int32))


def degenerate_async(data):
    """(a) ``buffer_k == concurrency == m`` with zero latency against the sync
    lane on the 2NN at full size: ``ASYNC_ROUNDS`` calls of ``run(1)`` each,
    the params bitwise equal after every one, the numpy streams in step,
    ``fedavg_aggregate`` once an apply and no other kernel."""
    from repro_torch.core import AsyncConfig, LatencyModel

    sync, _, _ = make_engine("mnist_2nn", data)
    m = sync._m
    asy, _, _ = make_engine("mnist_2nn", data, async_config=AsyncConfig(m, m),
                            latency=LatencyModel())
    launches, rows = 0, []
    for _ in range(ASYNC_ROUNDS):
        sync.run(1)
        reset_counts()
        asy.run(1)
        counts = launch_counts()
        want = {k: int(k == "fedavg_aggregate") for k in KERNELS}
        require(counts == want, f"degenerate apply: launches {counts}, want {want}")
        launches += 1
        same = leaves_equal(sync.params, asy.params)
        stream = sync.rng.bit_generator.state == asy.rng.bit_generator.state
        a, b = sync.history.records[-1], asy.history.records[-1]
        rows.append({"round": a.round, "params_bitwise": same, "streams_equal": stream,
                     "loss_sync": a.train_loss, "loss_async": b.train_loss,
                     "wall_s_sync": a.wall_s, "wall_s_async": b.wall_s})
        print(f"  round {a.round}: params bitwise {same}, numpy streams equal {stream}; loss "
              f"sync {a.train_loss!r} async {b.train_loss!r} (rel {abs(a.train_loss - b.train_loss) / a.train_loss:.2e}); "
              f"wall_s sync {a.wall_s:.4f} async {b.wall_s:.4f}")
        require(same and stream, "the degenerate async schedule left the sync lane")
    return {"rounds": rows, "launches": launches}


def async_vs_straggler_sync(train, test):
    """(b) ``mnist_2nn_noniid_async`` (K = 3 of m = 10 in flight) against the
    2NN's sync lane under the same straggler model, ``ASYNC_ROUNDS`` applies
    and rounds: seconds each, ``sim_s``, accuracy by simulated time; then one
    more ``run(1)`` of the async engine profiled (a fresh schedule: the
    first dispatch of m clients, the K-th arrival's apply)."""
    from repro_torch.core.engine import RoundEngine
    from repro_torch.specs import get_spec

    spec = get_spec("mnist_2nn_noniid_async")
    eng = RoundEngine.from_spec(spec, spec_clients(spec, train),
                                eval_fn=spec_eval_fn(spec, test))
    a_launch, a_walls, _ = run_lane(spec.name, eng, ASYNC_ROUNDS, "fedavg_aggregate")
    sync, _, _ = make_engine("mnist_2nn", (train, test), latency=spec.async_spec.latency)
    s_launch, s_walls, _ = run_lane("mnist_2nn_noniid + straggler model", sync, ASYNC_ROUNDS,
                                    "fedavg_aggregate")
    out = {}
    for name, e, walls in (("async", eng, a_walls), ("sync", sync, s_walls)):
        sim = [r.sim_s for r in e.history.records]
        acc = [r.test_acc for r in e.history.records]
        out[name] = {"wall_s": walls, "sim_s": sim, "test_acc": acc,
                     "sim_s_total": sum(sim)}
        print(f"  {name:5s}: seconds a {'apply' if name == 'async' else 'round'} "
              + ", ".join(f"{t:.4f}" for t in walls) + "; sim_s " + ", ".join(f"{v:.4f}" for v in sim)
              + f" ({sum(sim):.4f} simulated s); test_acc " + ", ".join(f"{a:.4f}" for a in acc))
    # CUPTI sometimes loses the apply's one kernel record (seen once on an
    # H100): a run(1) without it is profiled again, up to PROFILE_ATTEMPTS,
    # as phases 22, 25 and 26 profile a chunk again; each must launch once
    eval_fn, eng.eval_fn = eng.eval_fn, None
    launched = 0
    for _ in range(PROFILE_ATTEMPTS):
        before = counters()["fedavg_aggregate"].launches
        wall, ops, rows = device_profile(lambda: eng.run(1))
        once = counters()["fedavg_aggregate"].launches - before
        launched += once
        records = kernel_records(ops)
        require(once == 1 and records in ({}, {"fedavg_agg_kernel": 1}),
                f"profiled apply: {once} launches, kernel records {records}")
        print(f"  profiled run(1): kernel records {records}")
        if records:
            break
    else:
        raise AssertionError(f"{PROFILE_ATTEMPTS} profiled applies, none with its "
                             "fedavg_agg_kernel record")
    eng.eval_fn = eval_fn
    busy = busy_seconds((e.time_range.start, e.time_range.end) for e in ops)
    prof = {"wall_s": wall, "device_busy_s": busy, "idle_share": 1 - busy / wall,
            "device_ops": len(ops), "kernel_records": records}
    print(f"  one profiled run(1) of the async engine (its first dispatch of {eng._m} clients, "
          f"then the apply at the {spec.async_spec.buffer_k}rd arrival): wall {wall:.4f} s, "
          f"device busy {busy:.4f} s (idle share {1 - busy / wall:.1%}), {len(ops)} device ops, "
          f"kernel records {records}")
    for us, count, k in rows[:5]:
        print(f"    {us / 1e3:10.3f} ms {count:6d}x  {k[:90]}")
    out["profiled_apply"] = prof
    out["launches"] = a_launch + s_launch + launched
    return out


def copies_beside_kernels(ops):
    """The profiled round's host-to-device copies on streams that run no
    kernel (the stager's side stream) and how much of their time some
    kernel ran beside them: (those copies, their µs, overlapped µs, the
    host-to-device copies on any stream)."""
    copies = [e for e in ops if "HtoD" in e.name]
    kernels = [e for e in ops if "Memcpy" not in e.name and "Memset" not in e.name]
    kernel_streams = {e.device_resource_id for e in kernels}
    side = [e for e in copies if e.device_resource_id not in kernel_streams]
    spans = sorted((e.time_range.start, e.time_range.end) for e in kernels)
    total = overlapped = 0.0
    for c in side:
        s, t = c.time_range.start, c.time_range.end
        total += t - s
        overlapped += busy_seconds((max(a, s), min(b, t)) for a, b in spans
                                   if a < t and b > s) * 1e6
    return side, total, overlapped, len(copies)


def streamed_vs_device(data, spool):
    """(c) and (d): the 2NN and the CNN on the streamed pool against the
    device pool (rounds and params bitwise), the 2NN with prefetch 0, one q8
    2NN round on each; then 2NN rounds in turns (device, streamed) and one
    profiled streamed round."""
    from repro_torch.specs import get_spec

    out, launches = {"lanes": []}, {"fedavg_aggregate": 0, "quantized_aggregate": 0}
    main_route = {"quantized_aggregate": 0}   # read from the wrapper's route counter
    keep = {}
    q8 = get_spec("mnist_2nn_noniid_q8").build_codec()
    cases = (("mnist_2nn", None, {}), ("mnist_2nn", None, {"prefetch": 0}),
             ("mnist_cnn", None, {}), ("mnist_2nn", q8, {}))
    for model_name, codec, kw in cases:
        kernel = "fedavg_aggregate" if codec is None else "quantized_aggregate"
        n = STREAMED_ROUNDS[model_name] if codec is None else COMPRESSED_ROUNDS
        tag = model_name + (f" {codec.name}" if codec else "") + "".join(
            f" {k}={v}" for k, v in kw.items())
        deterministic = torch.backends.cudnn.deterministic
        torch.backends.cudnn.deterministic = model_name == "mnist_cnn" or deterministic
        try:
            dev = keep.get((model_name, codec))
            if dev is None:
                dev, _, _ = make_engine(model_name, data, codec=codec, pool="device")
                d_launch, d_walls, _ = run_lane(f"{tag} device pool", dev, n, kernel)
                launches[kernel] += d_launch
                if kernel in main_route:
                    main_route[kernel] += route_launches(kernel)[1]
            else:
                d_walls = [r.wall_s for r in dev.history.records]
            st, _, _ = make_engine(model_name, data, codec=codec, pool=spool, **kw)
            s_launch, s_walls, _ = run_lane(f"{tag} streamed pool", st, n, kernel)
            launches[kernel] += s_launch
            if kernel in main_route:
                main_route[kernel] += route_launches(kernel)[1]
        finally:
            torch.backends.cudnn.deterministic = deterministic
        same = leaves_equal(dev.params, st.params) and leaves_equal(
            dev.outer_state, st.outer_state) and [r.train_loss for r in dev.history.records] \
            == [r.train_loss for r in st.history.records]
        print(f"  {tag}: streamed == device over {n} rounds, params and losses bitwise: {same} "
              f"({'ok' if same else 'FAIL'}); staged {st.staged_bytes:,} B a round")
        require(same, f"{tag}: the streamed pool's rounds are not the device pool's")
        out["lanes"].append({"lane": tag, "rounds": n, "bitwise": same,
                             "staged_bytes": st.staged_bytes, "device_wall_s": d_walls,
                             "streamed_wall_s": s_walls})
        if (model_name, codec, tuple(kw)) == ("mnist_2nn", None, ()):
            keep[(model_name, codec)] = dev
            keep["streamed"] = st
        del st
        free_card()
    dev, st = keep[("mnist_2nn", None)], keep["streamed"]
    turns = []
    before = counters()["fedavg_aggregate"].launches
    for name, eng in (("device", dev), ("streamed", st)):
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        eng._read_loss(eng.round()["loss"])
        turns.append((name, time.perf_counter() - t0))
        print(f"  {name:8s} round {turns[-1][1]:.4f} s")
    mean = {k: float(np.mean([t for n, t in turns if n == k])) for k in ("device", "streamed")}
    ratio = mean["streamed"] / mean["device"]
    print(f"  2NN rounds in turns (device, streamed): streamed / device = "
          f"{ratio:.4f}; {st.staged_bytes:,} B staged host to device a streamed round")
    wall, ops, _ = device_profile(lambda: float(st.round()["loss"]))
    launches["fedavg_aggregate"] += counters()["fedavg_aggregate"].launches - before
    side, copy_us, over_us, n_copies = copies_beside_kernels(ops)
    busy = busy_seconds((e.time_range.start, e.time_range.end) for e in ops)
    verdict = (("overlap" if over_us > 0 else "do not overlap") + " the round's kernels"
               if side else "not measured: the profiler's records hold no side-stream copy "
               "(CUPTI drops a block of records now and then)")
    print(f"  one profiled streamed round: wall {wall:.4f} s, device busy {busy:.4f} s (idle "
          f"share {1 - busy / wall:.1%}), {len(ops)} device ops, {n_copies} host-to-device "
          f"copies in all; {len(side)} on the side stream (the next round's cohort, staged "
          f"after this round's dispatch), {copy_us:.1f} us, of which {over_us:.1f} us ran "
          f"beside a kernel: the copies {verdict}")
    out.update(turns=turns, streamed_over_device=ratio, staged_bytes=st.staged_bytes,
               profiled_round={"wall_s": wall, "device_busy_s": busy,
                               "idle_share": 1 - busy / wall, "device_ops": len(ops),
                               "htod_copies": n_copies,
                               "side_copies": len(side), "side_copy_us": copy_us,
                               "overlapped_us": over_us})
    for kernel, n in main_route.items():
        require(n == launches[kernel], f"{n} of {launches[kernel]} {kernel} launches of "
                                       "the streamed-vs-device lanes on the stream route")
    out["launches"], out["main_route_launches"] = launches, main_route
    return out


def auto_selects_streamed(data, spool, root):
    """(e) ``pool="auto"`` with ``REPRO_DEVICE_POOL_BUDGET`` below the 2NN
    pool's estimate selects the streamed pool."""
    import os

    est = spool.estimated_device_nbytes()
    os.environ["REPRO_DEVICE_POOL_BUDGET"] = str(est // 2)
    try:
        eng, _, _ = make_engine("mnist_2nn", data, pool="auto", pool_dir=root / "auto")
    finally:
        del os.environ["REPRO_DEVICE_POOL_BUDGET"]
    require(eng.pool_kind == "streamed", f"pool='auto' under a budget of {est // 2} B chose "
                                         f"{eng.pool_kind}")
    print(f"  pool='auto' with REPRO_DEVICE_POOL_BUDGET={est // 2} (the packed estimate "
          f"{est:,} B): {eng.pool_kind}, {eng.pool.num_shards} shards, "
          f"{eng.pool.nbytes_on_disk():,} B on disk")
    return {"budget": est // 2, "estimate": est, "pool_kind": eng.pool_kind}


def population_gate(root):
    """(f) ``benchmarks/round_engine.py``'s population gate on the
    host-sampled lane: K = 10^5 generated clients into shards of 4096 (one
    shard in RAM at a time), m = 20, ``POP_ROUNDS`` streamed rounds; the
    process's RSS growth from before the build to after the rounds must stay
    under ``POP_RSS_MB`` with the pool larger than that on disk. The start
    is read after two warm-up rounds of the same model and cohort shape on a
    population of ``POP_WARM`` clients, so that the CUDA libraries' loads on
    first use (the first round of a new shape grew this process by ~1.2 GB
    on an H100 machine, with no population at all) are not charged to the
    population; the warm-up's own growth is printed beside."""
    from repro_torch.core.engine import RoundEngine
    from repro_torch.core.fedavg import FedAvgConfig
    from repro_torch.data.pool import StreamedClientPool
    from repro_torch.models import paper

    model = paper.mnist_2nn(n_classes=5, d_in=POP_D, device="cuda")
    gc.collect()
    rss_w = rss_mb()
    warm = StreamedClientPool.from_generator(synth_clients(POP_WARM, POP_ROWS, POP_D, seed=2),
                                             POP_ROWS, shard_clients=POP_SHARD,
                                             root=root / "warm-up")
    RoundEngine(model.loss, model.init(2), None,
                FedAvgConfig(C=POP_M / POP_WARM, E=1, B=POP_ROWS, lr=0.1, seed=0), pool=warm,
                device="cuda").run(2)
    del warm
    gc.collect()
    rss0 = rss_mb()
    print(f"  warm-up: 2 rounds of m={POP_M} on {POP_WARM} clients grew the process "
          f"{rss0 - rss_w:.1f} MB")
    t0 = time.perf_counter()
    pool = StreamedClientPool.from_generator(synth_clients(POP_K, POP_ROWS, POP_D, seed=1),
                                             POP_ROWS, shard_clients=POP_SHARD,
                                             root=root / "population")
    build_s = time.perf_counter() - t0
    cfg = FedAvgConfig(C=POP_M / POP_K, E=1, B=POP_ROWS, lr=0.1, seed=0)
    eng = RoundEngine(model.loss, model.init(2), None, cfg, pool=pool, device="cuda")
    require(eng._m == POP_M, f"cohort {eng._m}")
    reset_counts()
    t0 = time.perf_counter()
    hist = eng.run(POP_ROUNDS)
    run_s = time.perf_counter() - t0
    counts = launch_counts()
    growth = rss_mb() - rss0
    disk_mb = pool.nbytes_on_disk() / 1e6
    est_mb = pool.estimated_device_nbytes() / 1e6
    ok = growth < POP_RSS_MB and disk_mb > POP_RSS_MB
    print(f"  K={POP_K:,} clients of {POP_ROWS}x{POP_D} fp32 from a generator into "
          f"{pool.num_shards} shards of {POP_SHARD}: {disk_mb:.1f} MB on disk (the device "
          f"pack would take {est_mb:.1f} MB), built in {build_s:.2f} s; {POP_ROUNDS} streamed "
          f"rounds of m={POP_M} in {run_s:.3f} s ({run_s / POP_ROUNDS:.4f} s a round), losses "
          + ", ".join(f"{r.train_loss:.4f}" for r in hist.records[:3]) + " ...; RSS growth "
          f"{growth:.1f} MB (required < {POP_RSS_MB:.0f}) {'ok' if ok else 'FAIL'}")
    require(counts["fedavg_aggregate"] == POP_ROUNDS and all(math.isfinite(r.train_loss)
                                                            for r in hist.records),
            f"population rounds: launches {counts}")
    require(ok, f"RSS grew {growth:.1f} MB with a {disk_mb:.1f} MB pool on disk")
    return {"K": POP_K, "disk_MB": disk_mb, "device_estimate_MB": est_mb, "build_s": build_s,
            "seconds_a_round": run_s / POP_ROUNDS, "rss_growth_MB": growth,
            "warm_up_growth_MB": rss0 - rss_w,
            "launches": counts["fedavg_aggregate"]}


def async_streamed_phase(train, test):
    """Phase 24: (a)-(f) above. The shards go to a directory under
    ``build/``, removed after."""
    import shutil
    import tempfile

    from repro_torch.data.pool import StreamedClientPool

    data = (train, test)
    out = {}
    phase_t0 = time.perf_counter()
    print("  (a) the degenerate async schedule against the sync lane, 2NN")
    out["degenerate"] = degenerate_async(data)
    free_card()
    print("  (b) mnist_2nn_noniid_async against the sync lane under its straggler model")
    out["straggler"] = async_vs_straggler_sync(train, test)
    free_card()
    (ROOT / "build").mkdir(exist_ok=True)
    root = Path(tempfile.mkdtemp(prefix="chip_smoke_pool_", dir=ROOT / "build"))
    try:
        spec = json.loads((ROOT / "specs" / "mnist_2nn_noniid.json").read_text())
        t0 = time.perf_counter()
        spool = StreamedClientPool.build(noniid_clients(train, spec), spec["fedavg"]["B"],
                                         root=root / "noniid")
        print(f"  the non-IID population's streamed pool: {spool.num_clients} clients, "
              f"{spool.num_shards} shard(s), {spool.nbytes_on_disk():,} B on disk, built in "
              f"{time.perf_counter() - t0:.2f} s")
        print("  (c, d) the streamed pool against the device pool")
        out["streamed"] = streamed_vs_device(data, spool)
        free_card()
        print("  (e) pool='auto' over the budget")
        out["auto"] = auto_selects_streamed(data, spool, root)
        del spool
        free_card()
        print("  (f) the population gate")
        out["population"] = population_gate(root)
    finally:
        shutil.rmtree(root)
    free_card()
    out["launches"] = {
        "fedavg_aggregate": (out["degenerate"]["launches"] + out["straggler"]["launches"]
                             + out["streamed"]["launches"]["fedavg_aggregate"]
                             + out["population"]["launches"]),
        "quantized_aggregate": out["streamed"]["launches"]["quantized_aggregate"]}
    out["main_route_launches"] = out["streamed"]["main_route_launches"]
    out["seconds"] = time.perf_counter() - phase_t0
    print(f"  phase 24: launches {out['launches']} in {out['seconds']:.1f} s")
    return out


# ---------------------------------------------------------------------------
# phase 25: cohort sharding
# ---------------------------------------------------------------------------

def partial_counts():
    """Partial-sum launches (``normalized=False``) of the four aggregation
    kernels since the counts were reset."""
    return {k: counters()[k].partial_launches for k in PARTIAL_KERNELS}


def partial_weights(kind, K, seed):
    """(K,) raw weights on the card: ``"raw"`` counts (sum >> 1), ``"ghosts"``
    the same with the last two rows 0, ``"zero"`` all 0 (an all-ghost rank)."""
    w = np.random.default_rng(seed).integers(300, 900, K).astype(np.float32)
    if kind == "ghosts":
        w[-2:] = 0.0
    elif kind == "zero":
        w[:] = 0.0
    return torch.from_numpy(w).cuda()


def partial_check(name, tag, out, ref, term_max, kind):
    """``sum_check`` on the largest weighted term; an all-zero vector's sum
    must be exactly 0."""
    if kind == "zero":
        require(torch.equal(out, torch.zeros_like(out)),
                f"{name} {tag}: an all-zero weight vector did not give exactly 0")
    return sum_check(name, tag, out, ref, max(term_max, 1e-30))


def check_partial_sum_mode():
    """25(a): each of the four aggregation kernels in partial-sum mode
    (``normalized=False``) on every route, at the 2NN and CNN shapes (K =
    MAIN_K), with raw counts, ghost rows (weight 0, data 1e4) and an
    all-zero vector, against its plain version on the same raw weights.
    Returns each kernel's worst error."""
    from repro_torch.kernels import sparse_agg
    from repro_torch.kernels.fedavg_agg import fedavg_aggregate, fedavg_aggregate_ref
    from repro_torch.kernels.quantized_agg import (
        _launch,
        _out,
        dequantize_ref,
        packed_quantized_aggregate_ref,
        quantized_aggregate_ref,
        unpack_ref,
    )
    from repro_torch.utils.bitpack import words_per_chunk

    errs = dict.fromkeys(PARTIAL_KERNELS, 0.0)
    K = MAIN_K
    reset_counts()
    for model_name, N in MAIN_N.items():
        C = -(-N // CHUNK)
        k = int(N * TOPK)
        g = torch.Generator(device="cuda").manual_seed(N)
        x = torch.randn((K, N), generator=g, device="cuda")
        codes = random_codes(K, C * CHUNK, torch.uint8, seed=N)
        words = torch.randint(-2**31, 2**31, (K, C * words_per_chunk(CHUNK, 4)), generator=g,
                              dtype=torch.int32, device="cuda")
        lo, scale = ranges(K, C, seed=N)
        idx = torch.stack([torch.randperm(N, generator=g, device="cuda")[:k]
                           for _ in range(K)]).to(torch.int32)
        vals = torch.randn((K, k), generator=g, device="cuda")
        for kind in ("raw", "ghosts", "zero"):
            w = partial_weights(kind, K, seed=N)
            real = K - 2 if kind == "ghosts" else K
            if kind == "ghosts":
                x[real:], lo[real:], vals[real:] = 1e4, 1e4, 1e4
            wmax = float(w.max())
            tag = f"{model_name} N={N} {kind}"
            out = fedavg_aggregate(x, w, normalized=False)
            errs["fedavg_aggregate"] = max(errs["fedavg_aggregate"], partial_check(
                "fedavg_aggregate", tag, out, fedavg_aggregate_ref(x, w),
                wmax * float(x[:real].abs().max()), kind))
            dense = {8: dequantize_ref(codes[:real], lo[:real], scale[:real], chunk=CHUNK,
                                       levels=255),
                     4: dequantize_ref(unpack_ref(words[:real], bits=4, chunk=CHUNK),
                                       lo[:real], scale[:real], chunk=CHUNK, levels=15)}
            for bits, payload, kernel, ref in (
                    (8, codes, "quantized_aggregate", quantized_aggregate_ref(
                        codes, lo, scale, w, chunk=CHUNK, levels=255)),
                    (4, words, "packed_quantized_aggregate", packed_quantized_aggregate_ref(
                        words, lo, scale, w, bits=4, chunk=CHUNK, levels=15))):
                for route in ("stream", "general"):
                    got = _launch(payload, lo, scale, w, _out(payload, lo, CHUNK), bits=bits,
                                  chunk=CHUNK, levels=2**bits - 1, route=route,
                                  normalized=False)
                    errs[kernel] = max(errs[kernel], partial_check(
                        kernel, f"{tag} q{bits} {route}", got, ref,
                        wmax * float(dense[bits].abs().max()), kind))
            ref = sparse_agg.sparse_aggregate_ref(idx, vals, w, N)
            for route in sparse_agg.ROUTES:
                got = sparse_agg._launch(idx, vals, w, torch.empty(N, device="cuda"), route,
                                         normalized=False)
                errs["sparse_aggregate"] = max(errs["sparse_aggregate"], partial_check(
                    "sparse_aggregate", f"{tag} top-k {route}", got, ref,
                    wmax * float(vals[:real].abs().max()), kind))
    cases = 2 * 3   # shapes x weight vectors
    want = {"fedavg_aggregate": cases, "quantized_aggregate": 2 * cases,
            "packed_quantized_aggregate": 2 * cases, "sparse_aggregate": 2 * cases}
    require(partial_counts() == want and launch_counts() == {
        k: want.get(k, 0) for k in KERNELS},
        f"partial-sum launches {partial_counts()}, want {want}")
    print("kernels in partial-sum mode: " + ", ".join(
        f"{k} {want[k]} launches, max_abs_err {errs[k]:.3e}" for k in PARTIAL_KERNELS)
          + " (within 1e-6*max|term|; every all-zero vector exactly 0)")
    return errs


def shard_lane_engine(lane, data, mesh=None, **kw):
    """The engine of a phase-25 lane at full size (``make_engine``), sharded
    over ``mesh`` when one is given."""
    from repro_torch.specs import get_spec

    _, model_name, spec_name, override, _ = lane
    codec = None
    if override is not None:
        codec = dataclasses.replace(get_spec(spec_name).codec, **override).build()
    elif spec_name is not None:
        kw.update(spec_name=spec_name, strategy=get_spec(spec_name).build_strategy())
    if mesh is not None:
        kw["mesh"] = mesh
    return make_engine(model_name, data, codec=codec, **kw)[0]


def param_gap(a, b) -> float:
    return float((host_vector(a) - host_vector(b)).abs().max())


def sharded_lanes(data, mesh):
    """25(b): each lane sharded over ``mesh`` (an NCCL world of one) against
    the unsharded engine from the same seed, SHARD_ROUNDS rounds each through
    ``run(1)`` in turns (unsharded, sharded, sharded, unsharded, ...): each
    round launches the lane's kernel once, the sharded ones in partial-sum
    mode; losses and params within the reference's tolerances. The 2NN plain
    lane also runs one warm sharded round under ``transfer_guard``. Returns
    the lanes, and the unsharded runs' losses and params for (d)."""
    from repro_torch.analysis import transfer_guard

    lanes, unsharded = [], {}
    for lane in SHARD_LANES:
        name, model_name, _, _, kernel = lane
        torch.backends.cudnn.deterministic = model_name == "mnist_cnn"   # as phase 22
        base = shard_lane_engine(lane, data)
        shrd = shard_lane_engine(lane, data, mesh=mesh)
        reset_counts()
        turns = []
        for tag in ("unsharded", "sharded", "sharded", "unsharded",
                    "unsharded", "sharded")[:2 * SHARD_ROUNDS]:
            eng = shrd if tag == "sharded" else base
            rec = eng.run(1).records[-1]
            turns.append((tag, rec.wall_s))
            print(f"  {name} {tag:9s} round {eng.round_idx}: loss {rec.train_loss:.6f} "
                  f"test_acc {rec.test_acc:.4f} wall_s {rec.wall_s:.4f}")
        torch.cuda.synchronize()
        counts, partial = launch_counts(), partial_counts()
        want = {k: (2 * SHARD_ROUNDS if k == kernel else 0) for k in KERNELS}
        require(counts == want, f"{name}: launches {counts}, want {want}")
        require(partial[kernel] == SHARD_ROUNDS and sum(partial.values()) == SHARD_ROUNDS,
                f"{name}: partial-sum launches {partial}, want {SHARD_ROUNDS} of {kernel}")
        require_main_route(name, kernel)
        lb = [r.train_loss for r in base.history.records]
        ls = [r.train_loss for r in shrd.history.records]
        dl = max(abs(a - b) for a, b in zip(lb, ls))
        dp = param_gap(base.params, shrd.params)
        bitwise = dp == 0.0 and lb == ls
        p_tol, l_tol = SHARD_TOL[name.split(" ", 1)[1]]
        ok = dp <= p_tol and dl <= l_tol and all(math.isfinite(v) for v in ls)
        print(f"  {name}: sharded vs unsharded after {SHARD_ROUNDS} rounds: params max|diff| "
              f"{dp:.3e} (tol {p_tol:g}), losses max|diff| {dl:.3e} (tol {l_tol:g})"
              f"{', bitwise' if bitwise else ''} {'ok' if ok else 'FAIL'}; {kernel} "
              f"{partial[kernel]} partial-sum launches of {counts[kernel]}")
        require(ok, f"{name}: the sharded run disagrees with the unsharded one")
        if name in SHARD_GLOO_LANES:
            unsharded[name] = {"losses": lb, "params": host_vector(base.params)}
        res = {"lane": name, "kernel": kernel, "rounds": SHARD_ROUNDS, "turns": turns,
               "partial_launches": partial[kernel], "launches": counts[kernel],
               "param_gap": dp, "loss_gap": dl, "bitwise": bitwise,
               "test_acc": shrd.history.records[-1].test_acc}
        if name == "mnist_2nn plain":
            with transfer_guard():
                shrd.run(1)
            print(f"  {name}: a warm sharded round under transfer_guard() made no sync")
            res["guarded_round"] = True
        lanes.append(res)
        del base, shrd, eng
        free_card()
    torch.backends.cudnn.deterministic = False
    for res in lanes:
        s = sorted(t for tag, t in res["turns"][1:] if tag == "sharded")
        u = sorted(t for tag, t in res["turns"][1:] if tag == "unsharded")
        print(f"  {res['lane']:18s} seconds a round (the first, unsharded, left out): unsharded "
              + " / ".join(f"{t:.4f}" for t in u) + ", sharded "
              + " / ".join(f"{t:.4f}" for t in s))
    return lanes, unsharded


def nccl_records(ops) -> int:
    """Device ops of NCCL's kernels among a profile's."""
    return sum(1 for e in ops if "nccl" in e.name.lower())


def sharded_superstep(data, mesh):
    """25(c): the 2NN superstep, a chunk of SUPERSTEP_R rounds under the NCCL
    mesh, against the unsharded superstep; chunks in turns; a warm chunk
    under ``transfer_guard`` and ``retrace_guard``; one profiled chunk whose
    kernel records must hold ``fedavg_agg_kernel`` once a replay, beside
    NCCL's records."""
    from repro_torch.analysis import retrace_guard, transfer_guard

    R = SUPERSTEP_R
    base, _, _ = make_engine("mnist_2nn", data, device_sampling=True)
    shrd, _, _ = make_engine("mnist_2nn", data, device_sampling=True, mesh=mesh)
    reset_counts()
    hb, hs = base.run(R, rounds_per_step=R), shrd.run(R, rounds_per_step=R)
    torch.cuda.synchronize()
    partial = partial_counts()
    require(launch_counts()["fedavg_aggregate"] == 2 and partial["fedavg_aggregate"] == 1,
            f"2NN superstep: warm-up launches {launch_counts()}, partial {partial}")
    dl = max(abs(a.train_loss - b.train_loss) for a, b in zip(hb.records, hs.records))
    dp = param_gap(base.params, shrd.params)
    ok = dp <= SHARD_TOL["plain"][0] and dl <= SHARD_TOL["plain"][1]
    print(f"  mnist_2nn superstep R={R}: sharded (NCCL, {shrd.num_compilations} graph) vs "
          f"unsharded: params max|diff| {dp:.3e}, losses max|diff| {dl:.3e}"
          f"{', bitwise' if dp == 0.0 and dl == 0.0 else ''} {'ok' if ok else 'FAIL'}; "
          f"capture {shrd._graph.capture_s:.3f} s")
    require(ok and shrd.num_compilations == 1, "the sharded superstep disagrees")
    turns = []
    for tag in ("unsharded", "sharded"):
        eng = shrd if tag == "sharded" else base
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        eng._superstep(R)
        turns.append((tag, (time.perf_counter() - t0) / R))
    print("  chunks in turns, seconds a round: "
          + ", ".join(f"{tag} {t:.5f}" for tag, t in turns))
    with transfer_guard():
        with retrace_guard(lambda: shrd.num_compilations, what="sharded superstep"):
            shrd.run(R, rounds_per_step=R)
    print("  a warm sharded chunk under transfer_guard() and retrace_guard(): no sync, no "
          "new graph")
    r = SUPERSTEP_PROFILE_R["mnist_2nn"]
    for attempt in range(PROFILE_ATTEMPTS):
        wall, ops, rows = device_profile(lambda: shrd._superstep(r))
        records, nccl = kernel_records(ops), nccl_records(ops)
        busy = busy_seconds((e.time_range.start, e.time_range.end) for e in ops)
        print(f"  a profiled sharded chunk of {r}: wall {wall:.4f} s, device busy {busy:.4f} s "
              f"(idle {1 - busy / wall:.1%}), {len(ops)} device ops; hand kernels {records}, "
              f"NCCL kernels {nccl}")
        require(set(records) <= {"fedavg_agg_kernel"}, f"sharded chunk records {records}")
        if records.get("fedavg_agg_kernel", 0) == r:
            break
    else:
        raise AssertionError(f"{PROFILE_ATTEMPTS} profiled sharded chunks, none with {r} "
                             "fedavg_agg_kernel records")
    require(nccl in (0, r), f"{nccl} NCCL kernel records in {r} replays")
    print(f"  fedavg_agg_kernel once a replay; NCCL {'once a replay' if nccl else 'no kernel (a world of one reduces in place)'}")
    res = {"rounds": R, "param_gap": dp, "loss_gap": dl, "turns": turns,
           "capture_s": shrd._graph.capture_s, "profile": {
               "rounds": r, "wall_s": wall, "device_busy_s": busy,
               "idle_share": 1 - busy / wall, "device_ops": len(ops),
               "kernel_records": records, "nccl_records": nccl},
           "launches": 1 + records["fedavg_agg_kernel"]}
    del base, shrd
    free_card()
    return res


def sharded_from_spec(train, test):
    """25(e): ``mnist_2nn_noniid`` with ``execution.mesh_axes="clients"``
    through ``RoundEngine.from_spec``: the mesh over the world that is up
    (phase 25's NCCL world of one), one round, one partial-sum launch."""
    import torch.distributed as dist

    from repro_torch.core.engine import RoundEngine
    from repro_torch.specs import ExecutionSpec, get_spec

    spec = dataclasses.replace(get_spec("mnist_2nn_noniid"),
                               execution=ExecutionSpec(mesh_axes="clients"))
    eng = RoundEngine.from_spec(spec, spec_clients(spec, train), eval_fn=spec_eval_fn(spec, test))
    backend = dist.get_backend(eng.mesh.get_group("clients"))
    reset_counts()
    rec = eng.run(1).records[-1]
    torch.cuda.synchronize()
    partial = partial_counts()
    require(backend == "nccl" and eng._shards == 1, f"from_spec built a {backend} mesh")
    require(partial["fedavg_aggregate"] == 1 == launch_counts()["fedavg_aggregate"],
            f"from_spec's sharded round: partial-sum launches {partial}")
    require(math.isfinite(rec.train_loss), "from_spec's sharded round lost its loss")
    print(f"  {spec.name} with execution.mesh_axes='clients' through from_spec: a {backend} "
          f"mesh of {eng._shards}, round 1 loss {rec.train_loss:.6f} test_acc "
          f"{rec.test_acc:.4f} wall_s {rec.wall_s:.4f}, fedavg_aggregate 1 partial-sum launch")
    out = {"spec": spec.name, "backend": backend, "loss": rec.train_loss,
           "test_acc": rec.test_acc, "wall_s": rec.wall_s, "launches": 1}
    del eng
    free_card()
    return out


def gloo_rank(rank, world, root):
    """One rank of 25(d), in a process of its own on ``cuda:0``: a gloo world
    over a FileStore under ``root``, the SHARD_GLOO_LANES sharded at full
    size, SHARD_ROUNDS rounds each; its losses, params, round seconds and
    launches to ``root/rank<r>-<i>.npz``."""
    import os

    import torch.distributed as dist

    from repro_torch.launch.mesh import make_client_mesh

    os.environ.setdefault("GLOO_SOCKET_IFNAME", "lo")
    torch.cuda.set_device(0)
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    root = Path(root)
    dist.init_process_group("gloo", store=dist.FileStore(str(root / "store"), world),
                            rank=rank, world_size=world)
    try:
        mesh = make_client_mesh(device="cuda")
        from repro_torch.data.synthetic import ArrayDataset

        data = tuple(ArrayDataset(np.load(root / f"{s}_x.npy", mmap_mode="r"),
                                  np.load(root / f"{s}_y.npy")) for s in ("train", "test"))
        lanes = {lane[0]: lane for lane in SHARD_LANES}
        for i, name in enumerate(SHARD_GLOO_LANES):
            eng = shard_lane_engine(lanes[name], data, mesh=mesh)
            reset_counts()
            hist = eng.run(SHARD_ROUNDS)
            torch.cuda.synchronize()
            np.savez(root / f"rank{rank}-{i}.npz",
                     losses=np.asarray([r.train_loss for r in hist.records]),
                     walls=np.asarray([r.wall_s for r in hist.records]),
                     params=host_vector(eng.params).numpy(),
                     slots=np.asarray(eng._slots[:3]),
                     launches=np.asarray([launch_counts()[lanes[name][4]],
                                          partial_counts()[lanes[name][4]]]))
            del eng
    finally:
        dist.destroy_process_group()


def gloo_world(train, test, unsharded):
    """25(d): SHARD_GLOO_WORLD ranks sharing the card under gloo, spawned from
    here: m = 10 over 3 ranks (12 slots, 2 ghosts on the last). Every rank
    must finish before the deadline with the same params, each lane's
    kernel once a round in partial-sum mode, and the run must equal (b)'s
    unsharded run within the reference's tolerances."""
    import shutil
    import tempfile

    import torch.multiprocessing as mp

    (ROOT / "build").mkdir(exist_ok=True)
    root = Path(tempfile.mkdtemp(prefix="chip_smoke_gloo_", dir=ROOT / "build"))
    W = SHARD_GLOO_WORLD
    try:
        for s, d in (("train", train), ("test", test)):
            np.save(root / f"{s}_x.npy", d.x)
            np.save(root / f"{s}_y.npy", d.y)
        t0 = time.perf_counter()
        ctx = mp.start_processes(gloo_rank, args=(W, str(root)), nprocs=W, join=False,
                                 start_method="spawn")
        try:
            while not ctx.join(timeout=5):
                if time.perf_counter() - t0 > SHARD_GLOO_DEADLINE_S:
                    raise AssertionError(f"the gloo world of {W} did not finish in "
                                         f"{SHARD_GLOO_DEADLINE_S:.0f} s")
        finally:
            for p in ctx.processes:
                if p.is_alive():
                    p.kill()
        wall = time.perf_counter() - t0
        print(f"  {W} ranks spawned on cuda:0 under gloo finished in {wall:.1f} s")
        lanes = []
        for i, name in enumerate(SHARD_GLOO_LANES):
            ranks = [dict(np.load(root / f"rank{r}-{i}.npz")) for r in range(W)]
            kernel = {lane[0]: lane[4] for lane in SHARD_LANES}[name]
            slots = [r["slots"].tolist() for r in ranks]
            require(slots == [[MAIN_K, 4 * r, 4 * r + 4] for r in range(W)],
                    f"{name}: slots {slots}")
            require(all(r["launches"].tolist() == [SHARD_ROUNDS, SHARD_ROUNDS] for r in ranks),
                    f"{name}: (launches, partial) {[r['launches'].tolist() for r in ranks]}")
            require(all(np.array_equal(r["params"], ranks[0]["params"]) and
                        np.array_equal(r["losses"], ranks[0]["losses"]) for r in ranks),
                    f"{name}: the ranks' params or losses differ")
            want = unsharded[name]
            dl = float(np.abs(ranks[0]["losses"] - np.asarray(want["losses"])).max())
            dp = float(np.abs(ranks[0]["params"] - want["params"].numpy()).max())
            p_tol, l_tol = SHARD_TOL[name.split(" ", 1)[1]]
            ok = dp <= p_tol and dl <= l_tol
            walls = ranks[0]["walls"].tolist()
            print(f"  {name} over {W} gloo ranks (slots {slots}): params max|diff| {dp:.3e} "
                  f"(tol {p_tol:g}), losses max|diff| {dl:.3e} (tol {l_tol:g}) against (b)'s "
                  f"unsharded run {'ok' if ok else 'FAIL'}; {kernel} once a round a rank in "
                  "partial-sum mode; rank 0's rounds " + ", ".join(f"{t:.4f}" for t in walls)
                  + " s")
            require(ok, f"{name}: the gloo world disagrees with the unsharded run")
            lanes.append({"lane": name, "kernel": kernel, "world": W, "slots": slots,
                          "param_gap": dp, "loss_gap": dl, "round_wall_s": walls,
                          "launches": W * SHARD_ROUNDS})
        return {"wall_s": wall, "lanes": lanes}
    finally:
        shutil.rmtree(root)


def cohort_shard_phase(train, test):
    """Phase 25 (module docstring). A driver can call it alone after
    ``build_all``."""
    import torch.distributed as dist

    from repro_torch.launch.mesh import make_client_mesh

    print("  (a) the four kernels in partial-sum mode against their plain versions")
    errs = check_partial_sum_mode()
    require(not dist.is_initialized(), "a process group is up before phase 25")
    mesh = make_client_mesh(device="cuda")
    print(f"  an NCCL world of {dist.get_world_size()}: {mesh}")
    try:
        print(f"  (b) sharded against unsharded at full size, {SHARD_ROUNDS} rounds a lane")
        lanes, unsharded = sharded_lanes((train, test), mesh)
        print(f"  (c) the 2NN superstep under the NCCL mesh, R = {SUPERSTEP_R}")
        superstep = sharded_superstep((train, test), mesh)
        print("  (e) from_spec with execution.mesh_axes")
        spec = sharded_from_spec(train, test)
    finally:
        dist.destroy_process_group()
    print(f"  (d) {SHARD_GLOO_WORLD} ranks sharing the card under gloo")
    gloo = gloo_world(train, test, unsharded)
    launches = dict.fromkeys(PARTIAL_KERNELS, 0)
    for lane in lanes:
        launches[lane["kernel"]] += lane["partial_launches"]
    launches["fedavg_aggregate"] += superstep["launches"] + spec["launches"]
    for lane in gloo["lanes"]:
        launches[lane["kernel"]] += lane["launches"]
    return {"errs": errs, "lanes": lanes, "superstep": superstep, "from_spec": spec,
            "gloo": gloo, "partial_launches": launches}


# ---------------------------------------------------------------------------
# phase 26: supersteps off the star lanes
# ---------------------------------------------------------------------------

def gossip_route_kernel(eng):
    """(route, the route's kernel name in the records) of ``eng``'s plan."""
    from repro_torch.kernels.gossip_mix import _route

    route = _route(torch.empty((eng.plan.n_nodes, 1), device="meta"), eng._mix_idx,
                   eng._mix_w)
    return route, "gossip_mix_dense_kernel" if route == "dense" else "gossip_mix_kernel"


def gossip_turn(eng, which, r):
    """``r`` rounds of the gossip engine ``eng``: eager (``run(r)``, R = 1,
    a sync a round) or one captured chunk (``run(r, rounds_per_step=r)``),
    evaluated once at the end; the turn's records."""
    hist = eng.run(r, eval_every=10**9, rounds_per_step=1 if which == "eager" else r)
    recs = hist.records[-r:]
    require(all(math.isfinite(x.train_loss) and math.isfinite(x.consensus) for x in recs),
            f"non-finite losses or consensus in a {which} gossip turn")
    return recs


def same_gossip_run(a, b, r):
    """Replicas, the last ``r`` records' losses and consensus distances and
    the device generators of two gossip engines, all bit for bit."""
    ra, rb = a.history.records[-r:], b.history.records[-r:]
    return (leaves_equal(a.params, b.params)
            and [x.train_loss for x in ra] == [x.train_loss for x in rb]
            and [x.consensus for x in ra] == [x.consensus for x in rb]
            and torch.equal(a._gen.get_state(), b._gen.get_state()))


def gossip_superstep_lane(model_name, spec_name, topo_kind, data, ckpt_root):
    """26(a), one lane: two engines built alike, ``a`` eager and ``b``
    captured, run R rounds each in turns (GOSSIP_TURN_PAIRS pairs of eager,
    captured; then captured, eager) and must agree bit for bit after each pair (the CNN under
    ``cudnn.deterministic``); the wrappers count the eager rounds and the
    capture's warm-up. The 2NN ring
    then runs a chunk under ``transfer_guard`` and ``retrace_guard`` and
    resumes (2 + ``save``/``restore`` into a fresh engine + 2 == 4); each 2NN
    lane profiles a chunk of ``GOSSIP_PROFILE_R``, whose records must hold
    the route's kernel once a replay."""
    from repro_torch.analysis import retrace_guard, transfer_guard
    from repro_torch.core.topology import FullTopology
    from repro_torch.specs import get_spec

    topo = FullTopology() if topo_kind == "full" else get_spec(spec_name).topology.build()
    name = f"{model_name} {topo.kind}"
    R = GOSSIP_STEP_R[(model_name, topo.kind)]
    require(R >= 2, f"{name}: a chunk of {R} would run the eager loop, not the graph")
    lr = GOSSIP_CNN_LR if model_name == "mnist_cnn" else None
    deterministic = torch.backends.cudnn.deterministic
    torch.backends.cudnn.deterministic = model_name == "mnist_cnn" or deterministic
    try:
        a, _, _ = make_engine(model_name, data, spec_name=spec_name, topology=topo, lr=lr)
        b, _, _ = make_engine(model_name, data, spec_name=spec_name, topology=topo, lr=lr)
        route, main = gossip_route_kernel(a)
        replica_mb = a.num_clients * MAIN_N[model_name] * 4 / 1e6
        gc.collect()
        torch.cuda.empty_cache()
        torch.cuda.reset_peak_memory_stats()
        reset_counts()
        turns = []
        pairs = (("eager", "captured"), ("captured", "eager"))[:GOSSIP_TURN_PAIRS[model_name]]
        for first, second in pairs:
            for which in (first, second):
                eng = a if which == "eager" else b
                capturing = which == "captured" and eng.num_compilations == 0
                torch.cuda.synchronize()
                t0 = time.perf_counter()
                recs = gossip_turn(eng, which, R)
                graph = eng._graph
                capture = graph.warmup_s + graph.capture_s if capturing else 0.0
                turn = {"which": which, "s_a_round": sum(x.wall_s for x in recs) / R,
                        "s_a_round_without_capture":
                            (time.perf_counter() - t0 - capture) / R,
                        "consensus": recs[-1].consensus, "test_acc": recs[-1].test_acc}
                turns.append(turn)
                print(f"  {name} {which:8s}: {R} rounds, {turn['s_a_round']:.4f} s a round"
                      + (f" ({turn['s_a_round_without_capture']:.4f} without the warm-up and "
                         "capture)" if capture else "")
                      + f", consensus {recs[-1].consensus:.6f}, test_acc "
                      f"{recs[-1].test_acc:.4f}")
            same = same_gossip_run(a, b, R)
            print(f"  {name}: {first} vs {second} over {R} rounds: replicas, losses, consensus "
                  f"and generator states bitwise {same} ({'ok' if same else 'FAIL'})")
            require(same, f"{name}: the captured gossip rounds are not the eager ones")
        torch.cuda.synchronize()
        peak = torch.cuda.max_memory_allocated() / 2**20
        counts = {k: v for k, v in launch_counts().items() if v}
        dense = counters()["gossip_mix"].dense_launches
        want = len(pairs) * R + 1
        require(counts == {"gossip_mix": want} and dense == (want if route == "dense" else 0)
                and (a.num_compilations, b.num_compilations) == (0, 1),
                f"{name}: the wrappers counted {counts} ({dense} dense), want {want} "
                f"gossip_mix on the {route} route: {len(pairs) * R} eager rounds and 1 "
                "warm-up")
        g = b._graph
        print(f"  {name}: {b.num_compilations} graph; warm-up {g.warmup_s:.3f} s, capture and "
              f"instantiation {g.capture_s:.3f} s; peak device memory {peak:.0f} MiB for two "
              f"engines, each with {replica_mb:.1f} MB of replicas (b's graph: its static "
              f"buffers, the warm-up's clones and its pool); the wrappers counted {want} "
              f"gossip_mix launches on the {route} route")
        lane = {"lane": name, "spec": spec_name, "topology": topo.name, "route": route,
                "rounds": R, "turns": turns, "bitwise": True, "warmup_s": g.warmup_s,
                "capture_s": g.capture_s, "peak_MiB": peak, "replicas_MB": replica_mb,
                "eager_launches": want}
        if (model_name, topo.kind) == ("mnist_2nn", "ring"):
            with transfer_guard():
                with retrace_guard(lambda: b.num_compilations, what=name):
                    b.run(R, eval_every=10**9, rounds_per_step=R)
            print(f"  {name}: a warm chunk of {R} under transfer_guard() and "
                  "retrace_guard(): no sync, no new graph ok")
            b.run(2, eval_every=10**9, rounds_per_step=2)
            b.save(ckpt_root / name.replace(" ", "_"))
            b.run(2, eval_every=10**9, rounds_per_step=2)
            c, _, _ = make_engine(model_name, data, spec_name=spec_name, topology=topo)
            c.restore(ckpt_root / name.replace(" ", "_"))
            c.run(2, eval_every=10**9, rounds_per_step=2)
            resumed = same_gossip_run(b, c, 2)
            print(f"  {name}: 2 + save/restore into a fresh engine + 2 against 4 (chunks of "
                  f"2): bitwise {resumed} ({'ok' if resumed else 'FAIL'})")
            require(resumed, f"{name}: the resumed gossip run left the straight one")
            lane["eager_launches"] += 1            # c's capture warm-up
            del c
        counts = {k: v for k, v in launch_counts().items() if v}
        dense = counters()["gossip_mix"].dense_launches
        require(counts == {"gossip_mix": lane["eager_launches"]},
                f"{name}: the wrappers counted {counts}, want {lane['eager_launches']} "
                "gossip_mix")
        if model_name == "mnist_2nn":     # profile_chunk sets the counts to 0
            lane["profile"] = profile_chunk(name, b, "gossip_mix", GOSSIP_PROFILE_R, main=main)
        replays = lane.get("profile", {}).get("launches", 0)
        lane["launches"] = lane["eager_launches"] + replays
        lane["dense_launches"] = dense + (replays if route == "dense" else 0)
    finally:
        torch.backends.cudnn.deterministic = deterministic
    del a, b
    free_card()
    return lane


def lowrank_superstep(data):
    """26(b): ``_lowrank``'s codec under ``device_sampling=True`` on the 2NN:
    the sketch regrown on the card from the CPU's seeds (the integer words
    bitwise, the Gaussians within ``SKETCH_ATOL``); superstep(R) against R
    ``round()`` calls of a second engine; host-sampled rounds against
    chunks in turns; one payload's realized bytes against ``wire_bytes``."""
    from repro_torch.core import compression as comp
    from repro_torch.core.compression import realized_device_bytes
    from repro_torch.specs import get_spec

    codec = get_spec("mnist_2nn_noniid_lowrank").build_codec()
    n = MAIN_N["mnist_2nn"]
    d1, rank = comp._lowrank_dims(n)[0], int(codec.name[len("lowrank"):])
    seeds = torch.randint(0, 2**62, (MAIN_K,), generator=torch.Generator().manual_seed(26))
    words = (comp.sketch_bits(seeds.cuda(), 2 * d1 * rank).cpu(),
             comp.sketch_bits(seeds, 2 * d1 * rank))
    sketch = (comp.lowrank_sketch(seeds.cuda(), d1, rank).cpu(),
              comp.lowrank_sketch(seeds, d1, rank))
    err = float((sketch[0] - sketch[1]).abs().max())
    ok = torch.equal(*words) and err <= SKETCH_ATOL
    print(f"  the sketch of {MAIN_K} seeds, ({d1}, {rank}) each, card vs CPU: the 32-bit words "
          f"bitwise {torch.equal(*words)}, the Gaussians max_abs_err={err:.3e} (atol "
          f"{SKETCH_ATOL:g}), bitwise {torch.equal(*sketch)} {'ok' if ok else 'FAIL'}")
    require(ok, "the card's low-rank sketch is not the CPU's")
    box = {}
    a, _, _ = make_engine("mnist_2nn", data, codec=recording(codec, box), device_sampling=True)
    b, _, _ = make_engine("mnist_2nn", data, codec=codec, device_sampling=True)
    host, _, _ = make_engine("mnist_2nn", data, codec=codec)
    reset_counts()
    start = host_vector(a.params)
    la = [r.train_loss for r in a.run(LOWRANK_R, eval_every=10**9,
                                      rounds_per_step=LOWRANK_R).records]
    lb = torch.stack([b.round()["loss"] for _ in range(LOWRANK_R)]).cpu().tolist()
    pa, pb = host_vector(a.params), host_vector(b.params)
    loss_rel = max(abs(x - y) / abs(y) for x, y in zip(la, lb))
    rel = float((pa - pb).norm() / (pb - start).norm())
    gens = torch.equal(a._gen.get_state(), b._gen.get_state()) and torch.equal(
        a._ids_gen.get_state(), b._ids_gen.get_state())
    ok = loss_rel <= LOWRANK_REPLAY_RTOL and rel <= LOWRANK_REPLAY_RTOL and gens
    print(f"  superstep({LOWRANK_R}) vs {LOWRANK_R} x round(): losses within {loss_rel:.3e}, "
          f"final params |a - b| / |update| = {rel:.3e} (rtol {LOWRANK_REPLAY_RTOL:g}), "
          f"bitwise {la == lb and bool(torch.equal(pa, pb))}, generator states equal {gens} "
          f"{'ok' if ok else 'FAIL'}")
    require(ok, "the low-rank superstep disagrees with its rounds")
    turns = []
    for which in ("host", "superstep"):
        if which == "host":
            recs = host.run(LOWRANK_HOST_ROUNDS, eval_every=10**9).records[-LOWRANK_HOST_ROUNDS:]
        else:
            recs = a.run(LOWRANK_R, eval_every=10**9,
                         rounds_per_step=LOWRANK_R).records[-LOWRANK_R:]
        turns.append((which, sum(r.wall_s for r in recs) / len(recs)))
        require(all(math.isfinite(r.train_loss) for r in recs), "non-finite low-rank losses")
        print(f"  mnist_2nn lowrank {which:9s}: {len(recs):2d} rounds, {turns[-1][1]:.4f} s a "
              f"round, last loss {recs[-1].train_loss:.6f}")
    one = {k: v[0] for k, v in box["payloads"].items()}
    realized = realized_device_bytes(one)
    print(f"  one client's payload on the superstep lane: {realized} bytes realized, "
          f"wire_bytes({n}) = {codec.wire_bytes(n)}, table {WIRE_BYTES[n][codec.name]}")
    require(realized == codec.wire_bytes(n) == WIRE_BYTES[n][codec.name],
            "low-rank's realized bytes left its wire bytes")
    counts = {k: v for k, v in launch_counts().items() if v}
    require(not counts, f"the low-rank lanes launched hand kernels {counts}")
    res = {"sketch_max_abs_err": err, "words_bitwise": True, "loss_max_rel_diff": loss_rel,
           "params_rel_diff": rel, "turns": turns, "payload_bytes": realized,
           "capture_s": a._graph.capture_s}
    del a, b, host
    free_card()
    return res


def staged_superstep(data, spool):
    """26(c): the streamed pool's staged superstep against the device pool's
    superstep, the 2NN and CNN plain lanes and the 2NN q8 lane: an untimed
    first chunk each (the captures, the first staging, the slots' pinning),
    then chunks in turns (device, streamed), bitwise equal after the pair
    (the CNN under ``cudnn.deterministic``); the
    staged bytes a chunk and the pinned bytes; then one profiled streamed chunk: whether
    the next chunk's staging copies ran beside the replays' kernels."""
    from repro_torch.specs import get_spec

    out = {"lanes": []}
    launches = {"fedavg_aggregate": 0, "quantized_aggregate": 0}
    keep = None
    for model_name, spec_name in STAGED_LANES:
        codec = get_spec(spec_name).build_codec() if spec_name else None
        kernel = "fedavg_aggregate" if codec is None else "quantized_aggregate"
        tag = model_name + (f" {codec.name}" if codec else " plain")
        R = STAGED_R[model_name]
        deterministic = torch.backends.cudnn.deterministic
        torch.backends.cudnn.deterministic = model_name == "mnist_cnn" or deterministic
        try:
            dev, _, _ = make_engine(model_name, data, codec=codec, device_sampling=True,
                                    pool="device")
            st, _, _ = make_engine(model_name, data, codec=codec, device_sampling=True,
                                   pool=spool)
            reset_counts()
            turns = []
            for eng in (dev, st):     # the captures, the first staging, the slots' pinning
                t0 = time.perf_counter()
                eng.run(R, eval_every=10**9, rounds_per_step=R)
                print(f"  {tag} {'device' if eng is dev else 'streamed'}: a first chunk of {R} "
                      f"(capture {eng._graph.warmup_s + eng._graph.capture_s:.3f} s) in "
                      f"{time.perf_counter() - t0:.3f} s, not timed")
            for which, eng in (("device", dev), ("streamed", st)):
                torch.cuda.synchronize()
                t0 = time.perf_counter()
                recs = eng.run(R, eval_every=10**9, rounds_per_step=R).records[-R:]
                wall = time.perf_counter() - t0
                turns.append((which, wall / R))
                require(all(math.isfinite(r.train_loss) for r in recs), f"{tag}: non-finite")
                print(f"  {tag} {which:8s}: a chunk of {R}, {wall / R:.4f} s a round, last "
                      f"loss {recs[-1].train_loss:.6f}")
                if len(turns) == 2:
                    # a pending chunk has drawn ahead: its snapshot is the
                    # ids stream a device run holds
                    ids = (st._prefetched["ids_gen"] if st._prefetched is not None
                           else st._ids_gen.get_state())
                    same = leaves_equal(dev.params, st.params) and leaves_equal(
                        dev.outer_state, st.outer_state) and [
                        r.train_loss for r in dev.history.records] == [
                        r.train_loss for r in st.history.records] and torch.equal(
                        dev._ids_gen.get_state(), ids) and torch.equal(
                        dev._gen.get_state(), st._gen.get_state())
                    print(f"  {tag}: streamed == device after {len(st.history.records)} "
                          f"rounds, params, losses and generators bitwise: {same} "
                          f"({'ok' if same else 'FAIL'})")
                    require(same, f"{tag}: the staged superstep left the device pool's")
            torch.cuda.synchronize()
            counts = {k: v for k, v in launch_counts().items() if v}
            require(counts == {kernel: 2}, f"{tag}: the wrappers counted {counts}, want the "
                                           f"two warm-ups' {kernel}")
            require_main_route(tag, kernel)
            launches[kernel] += 2
        finally:
            torch.backends.cudnn.deterministic = deterministic
        mean = {k: float(np.mean([t for w, t in turns if w == k])) for k in ("device", "streamed")}
        ratio = mean["streamed"] / mean["device"]
        staged = R * st.staged_bytes
        pinned = st._stager.pinned_nbytes
        print(f"  {tag}: streamed / device = {ratio:.4f} (seconds a round, in turns; the "
              f"reference's gate is 1.3x, not held here); {staged:,} B staged a chunk of {R} "
              f"({st.staged_bytes:,} B a round), {pinned:,} B page-locked (two chunk slots)")
        out["lanes"].append({"lane": tag, "rounds_per_chunk": R, "turns": turns,
                             "streamed_over_device": ratio, "staged_bytes_a_chunk": staged,
                             "pinned_bytes": pinned, "bitwise": True})
        if (model_name, codec) == ("mnist_2nn", None):
            keep = st
        else:
            del st
        del dev
        free_card()
    r = STAGED_PROFILE_R
    keep._superstep(r)            # a chunk of r staged ahead for the profiled one
    stage_chunk, at = keep._stager.stage_chunk, {}

    def timed_stage(ids):         # when the host reaches the next chunk's staging
        at["stage"] = time.perf_counter()
        return stage_chunk(ids)

    keep._stager.stage_chunk = timed_stage
    tries = []
    for _ in range(PROFILE_ATTEMPTS):
        reset_counts()

        def chunk():
            at["call"] = time.perf_counter()
            keep._superstep(r)

        wall, ops, _ = device_profile(chunk)
        records = kernel_records(ops)
        side, copy_us, over_us, n_copies = copies_beside_kernels(ops)
        busy = busy_seconds((e.time_range.start, e.time_range.end) for e in ops)
        tries.append({"rounds": r, "wall_s": wall, "device_busy_s": busy,
                      "idle_share": 1 - busy / wall, "device_ops": len(ops),
                      "kernel_records": records, "htod_copies": n_copies,
                      "side_copies": len(side), "side_copy_us": copy_us,
                      "overlapped_us": over_us})
        verdict = (("overlap" if over_us > 0 else "do not overlap") + " the replays' kernels"
                   if side else "not measured: no side-stream copy in the records")
        lead = at["stage"] - at["call"]
        tries[-1]["host_reaches_staging_s"] = lead
        print(f"  a profiled streamed 2NN chunk of {r}: the host reached the next chunk's "
              f"staging {lead:.4f} s after the call (its {r} replays queued), against "
              f"{busy:.4f} s of device busy")
        print(f"  a profiled streamed 2NN chunk of {r}: wall {wall:.4f} s, device busy "
              f"{busy:.4f} s (idle share {1 - busy / wall:.1%}), {len(ops)} device ops, hand "
              f"kernels {records}; {len(side)} copies on the side stream (the next chunk, "
              f"staged after this one's replays were queued), {copy_us:.1f} us, {over_us:.1f} "
              f"us of it beside a kernel: the copies {verdict}")
        require(set(records) <= {"fedavg_agg_kernel"}, f"streamed chunk records {records}")
        if records.get("fedavg_agg_kernel", 0) == r:
            break
    else:
        raise AssertionError(f"{PROFILE_ATTEMPTS} profiled streamed chunks, none with {r} "
                             "fedavg_agg_kernel records")
    replays = sum(t["kernel_records"].get("fedavg_agg_kernel", 0) for t in tries)
    out.update(profiled_chunk={**tries[-1], "attempts": len(tries)}, launches=launches,
               replay_records=replays)
    del keep
    free_card()
    return out


def staged_population_gate(root):
    """26(c): phase 24 (f)'s 10^5-client population on the superstep lane:
    the same generated pool, m = 20, ``POP_ROUNDS`` rounds in one chunk
    (staged at once); the process's RSS growth from before the pool's build
    to after the chunk must stay under ``POP_RSS_MB``. The start is read
    after a warm-up chunk on a population of ``POP_WARM`` clients."""
    from repro_torch.core.engine import RoundEngine
    from repro_torch.core.fedavg import FedAvgConfig
    from repro_torch.data.pool import StreamedClientPool
    from repro_torch.models import paper

    model = paper.mnist_2nn(n_classes=5, d_in=POP_D, device="cuda")
    warm = StreamedClientPool.from_generator(synth_clients(POP_WARM, POP_ROWS, POP_D, seed=2),
                                             POP_ROWS, shard_clients=POP_SHARD,
                                             root=root / "warm-up-superstep")
    RoundEngine(model.loss, model.init(2), None,
                FedAvgConfig(C=POP_M / POP_WARM, E=1, B=POP_ROWS, lr=0.1, seed=0), pool=warm,
                device_sampling=True, device="cuda").run(POP_ROUNDS, rounds_per_step=POP_ROUNDS)
    del warm
    gc.collect()
    rss0 = rss_mb()
    t0 = time.perf_counter()
    pool = StreamedClientPool.from_generator(synth_clients(POP_K, POP_ROWS, POP_D, seed=1),
                                             POP_ROWS, shard_clients=POP_SHARD,
                                             root=root / "population-superstep")
    build_s = time.perf_counter() - t0
    eng = RoundEngine(model.loss, model.init(2), None,
                      FedAvgConfig(C=POP_M / POP_K, E=1, B=POP_ROWS, lr=0.1, seed=0), pool=pool,
                      device_sampling=True, device="cuda")
    require(eng._m == POP_M, f"cohort {eng._m}")
    reset_counts()
    t0 = time.perf_counter()
    hist = eng.run(POP_ROUNDS, rounds_per_step=POP_ROUNDS)
    run_s = time.perf_counter() - t0
    counts = launch_counts()
    growth = rss_mb() - rss0
    disk_mb = pool.nbytes_on_disk() / 1e6
    ok = growth < POP_RSS_MB and disk_mb > POP_RSS_MB
    print(f"  K={POP_K:,} clients ({disk_mb:.1f} MB on disk, built in {build_s:.2f} s), one "
          f"chunk of {POP_ROUNDS} rounds of m={POP_M} on the superstep lane in {run_s:.3f} s "
          f"(capture included), {eng.staged_bytes * POP_ROUNDS:,} B staged, "
          f"{eng._stager.pinned_nbytes:,} B page-locked; RSS growth {growth:.1f} MB "
          f"(required < {POP_RSS_MB:.0f}) {'ok' if ok else 'FAIL'}")
    require(counts["fedavg_aggregate"] == 1 and all(math.isfinite(r.train_loss)
                                                   for r in hist.records),
            f"population chunk: launches {counts}")
    require(ok, f"RSS grew {growth:.1f} MB with a {disk_mb:.1f} MB pool on disk")
    return {"K": POP_K, "disk_MB": disk_mb, "build_s": build_s, "chunk_s": run_s,
            "rss_growth_MB": growth, "launches": 1}


def superstep_from_spec(train, test):
    """26(d): ``RoundEngine.from_spec`` on the ring and small-world specs
    with ``execution.rounds_per_step``, the low-rank spec with
    ``device_sampling=True`` and ``mnist_2nn_noniid`` streamed with
    ``device_sampling=True``: one chunk of ``FROM_SPEC_R`` each."""
    from repro_torch.core.engine import RoundEngine
    from repro_torch.specs import ExecutionSpec, get_spec

    rows = []
    cases = (("mnist_2nn_noniid_ring", {}), ("mnist_2nn_noniid_smallworld", {}),
             ("mnist_2nn_noniid_lowrank", {"device_sampling": True}),
             ("mnist_2nn_noniid", {"device_sampling": True, "pool": "streamed"}))
    for name, ex in cases:
        spec = dataclasses.replace(get_spec(name), execution=ExecutionSpec(
            rounds_per_step=FROM_SPEC_R, **ex))
        eng = RoundEngine.from_spec(spec, spec_clients(spec, train),
                                    eval_fn=spec_eval_fn(spec, test))
        reset_counts()
        t0 = time.perf_counter()
        hist = eng.run(FROM_SPEC_R, eval_every=FROM_SPEC_R)
        wall = time.perf_counter() - t0
        counts = {k: v for k, v in launch_counts().items() if v}
        kernel = SPEC_KERNELS[name]
        require(eng.num_compilations == 1 and len(hist.records) == FROM_SPEC_R
                and all(math.isfinite(r.train_loss) for r in hist.records)
                and counts == ({kernel: 1} if kernel else {}),
                f"{name} {ex}: {eng.num_compilations} graphs, launches {counts}")
        tag = name + "".join(f" {k}={v!r}" for k, v in ex.items())
        print(f"  {tag}: rounds_per_step={FROM_SPEC_R}, one chunk in {wall:.3f} s (capture "
              f"included), {eng.num_compilations} graph, pool {eng.pool_kind}, test_acc "
              f"{hist.records[-1].test_acc:.4f}"
              + (f", consensus {hist.records[-1].consensus:.6f}" if eng.topology else ""))
        rows.append({"spec": tag, "kernel": kernel, "launches": 1 if kernel else 0,
                     "chunk_s": wall, "test_acc": hist.records[-1].test_acc})
        del eng
        free_card()
    return rows


def offstar_superstep_phase(train, test):
    """Phase 26: (a)-(d) above. Checkpoints and the streamed pools go to
    directories under ``build/``, removed after."""
    import shutil
    import tempfile

    from repro_torch.data.pool import StreamedClientPool

    data = (train, test)
    out = {}
    phase_t0 = time.perf_counter()
    (ROOT / "build").mkdir(exist_ok=True)
    root = Path(tempfile.mkdtemp(prefix="chip_smoke_offstar_", dir=ROOT / "build"))
    try:
        print("  (a) the gossip superstep")
        out["gossip"] = [gossip_superstep_lane(*lane, data, root) for lane in GOSSIP_STEP_LANES]
        print("  (b) low-rank under device sampling")
        out["lowrank"] = lowrank_superstep(data)
        print("  (c) the streamed pool's staged superstep")
        spec = json.loads((ROOT / "specs" / "mnist_2nn_noniid.json").read_text())
        spool = StreamedClientPool.build(noniid_clients(train, spec), spec["fedavg"]["B"],
                                         root=root / "noniid")
        out["streamed"] = staged_superstep(data, spool)
        del spool
        free_card()
        out["population"] = staged_population_gate(root)
        free_card()
        print("  (d) from_spec")
        out["from_spec"] = superstep_from_spec(train, test)
    finally:
        shutil.rmtree(root)
    # each kernel's launches by source: the wrappers' counts (eager rounds,
    # the captures' warm-ups) and the profiled chunks' kernel records (replays)
    sources = {
        "gossip_mix": {
            "wrappers": sum(lane["eager_launches"] for lane in out["gossip"]),
            "records": sum(lane.get("profile", {}).get("launches", 0) for lane in out["gossip"])},
        "fedavg_aggregate": {
            "wrappers": out["streamed"]["launches"]["fedavg_aggregate"]
            + out["population"]["launches"],
            "records": out["streamed"]["replay_records"]},
        "quantized_aggregate": {
            "wrappers": out["streamed"]["launches"]["quantized_aggregate"], "records": 0}}
    for row in out["from_spec"]:
        if row["kernel"]:
            sources[row["kernel"]]["wrappers"] += row["launches"]
    out["launch_sources"] = sources
    launches = {k: v["wrappers"] + v["records"] for k, v in sources.items()}
    out["launches"] = launches
    out["gossip_dense_launches"] = sum(lane["dense_launches"] for lane in out["gossip"])
    out["seconds"] = time.perf_counter() - phase_t0
    print(f"  phase 26: launches {launches} ({out['gossip_dense_launches']} gossip_mix on the "
          f"dense route) in {out['seconds']:.1f} s")
    return out


# ---------------------------------------------------------------------------
# phase 28: serving MLA and the vision stub
# ---------------------------------------------------------------------------

def mla_vision_serving_phase():
    """DeepSeek-V2-Lite whole, DeepSeek-V3 at full width cut to 4 layers and
    Qwen2-VL-7B whole (on stub embeddings with 3-D positions), each drawn on
    the card from seed 0: one request through ``serve.generate``
    (``serving_lane``), the prefill + decode == forward invariant at full
    width (Qwen2-VL in bf16; MLA at B = 1: one layer in bf16, the whole
    model in fp32 on fresh fp32 weights, its bf16 gap measured), and a
    profiled prefill and decode step of each; each model and its caches
    freed before the next."""
    from repro_torch.configs import get_config
    from repro_torch.models.transformer import TransformerLM

    print(f"  memory_allocated at the start {torch.cuda.memory_allocated() / 2**30:.2f} GiB")
    out = {"lanes": [], "invariant": [], "profile": {}, "models": []}
    for arch, n_layers in MLA_VISION_SERVING:
        t0 = time.perf_counter()
        cfg = get_config(arch)
        if n_layers:
            cfg = dataclasses.replace(cfg, n_layers=n_layers)
        model = TransformerLM(cfg, device="cuda")
        params = model.init(0)
        torch.cuda.synchronize()
        init_s = time.perf_counter() - t0
        n_params = cfg.n_params()
        plan = [s.mixer + "/" + s.ffn for s in model.plan]
        print(f"  {arch}: {n_params:,} params ({len(plan)} layers: "
              f"{dict((k, plan.count(k)) for k in dict.fromkeys(plan))}) drawn on the card "
              f"from seed 0 in {init_s:.2f} s; {torch.cuda.memory_allocated() / 2**30:.2f} GiB "
              f"allocated")
        lane = serving_lane(arch, model, params)
        lane.update(params=n_params, layers=len(plan), init_s=init_s)
        out["lanes"].append(lane)
        if cfg.mla is None:
            out["invariant"].append(lm_invariant(arch, model, params))
        else:
            out["invariant"].append(lm_invariant(arch, model, params, MLA_INVARIANT_SHAPE,
                                                 rtol=None))
            out["invariant"] += mla_layer_invariant(arch, model, params)
        out["profile"][arch] = profile_serving(arch, model, params)
        out["models"].append({"arch": arch, "layers": len(plan), "params": n_params,
                              "init_s": init_s})
        del model, params
        free_card()
        if cfg.mla is not None:
            fp32 = dataclasses.replace(cfg, param_dtype="float32", compute_dtype="float32")
            model = TransformerLM(fp32, device="cuda")
            params = model.init(0)
            out["invariant"].append(lm_invariant(arch, model, params, MLA_INVARIANT_SHAPE,
                                                 rtol=MLA_FP32_INVARIANT_RTOL))
            del model, params
            free_card()
    return out


# ---------------------------------------------------------------------------
# phase 29: serving xLSTM and the encoder-decoder
# ---------------------------------------------------------------------------

def xlstm_prefill_ranges(model, params):
    """One xLSTM prefill (B = 4, 2048 tokens) under torch.profiler with CPU
    and CUDA activity: the idle share and device ops of the whole prefill,
    and of its ``mlstm_chunkwise`` (21 layers, fp32 einsums over chunks of
    1024) and ``slstm_scan`` (3 layers, 2048 steps each, one op at a time)
    ranges the device ms, ops and share of busy, and their host ms."""
    from torch.profiler import ProfilerActivity, profile

    prompt = serving_prompt(model.cfg, SERVE_BATCH, PROMPT)
    torch.cuda.synchronize()
    with profile(activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA]) as prof:
        t0 = time.perf_counter()
        model.prefill(params, prompt, cache_len=PROMPT + SERVE_TOKENS)
        torch.cuda.synchronize()
        wall = time.perf_counter() - t0
    ops, ranges = read_trace(prof, ("mlstm_chunkwise", "slstm_scan"))
    busy = busy_seconds((e.time_range.start, e.time_range.end) for e in ops)
    print(f"  xlstm-350m prefill under the profiler (CPU and CUDA activity): wall {wall:.4f} s, "
          f"device busy {busy:.4f} s (idle share {1 - busy / wall:.1%}), {len(ops)} device ops")
    for name, r in ranges.items():
        r["share_of_busy"] = r["device_ms"] / 1e3 / busy
        print(f"    {name}: {r['spans']} layers, {r['device_ops']} device ops, "
              f"{r['device_ms']:.3f} ms on the device ({r['share_of_busy']:.1%} of busy), "
              f"{r['host_ms']:.1f} ms of host time inside the range")
    require(ranges["slstm_scan"]["spans"] == 3 and ranges["mlstm_chunkwise"]["spans"] == 21,
            f"xlstm ranges {ranges}")
    return {"wall_s": wall, "device_busy_s": busy, "idle_share": 1 - busy / wall,
            "device_ops": len(ops), "ranges": ranges}


def row_gap(full, short):
    """(max |short - full[:, :S-1]| over max |full[:, :S-1]|, the share of
    values whose bits differ) of a forward over S - 1 rows against the
    first S - 1 rows of one over S."""
    head = full[:, :short.shape[1]]
    a, b = head.float(), short.float()
    return float((a - b).abs().max()) / float(a.abs().max()), float((head != short).float().mean())


def xlstm_row_count(model, params):
    """Does a row's output depend on how many rows there are? At
    INVARIANT_SHAPE in bf16, the forward over S - 1 tokens against the first
    S - 1 positions of the forward over S: one mLSTM and one sLSTM block
    (unit-normal inputs drawn on the card), the whole model's final hidden
    (the invariant's tokens), and the bf16 products alone: ``xlstm._mm``
    (fp32 sums, one rounding) and the plain bf16 ``x @ w`` they replaced, on
    the mLSTM's ``up`` and the sLSTM FFN's ``wi`` over 2 x (S - 1) and 2
    rows (the decode step's) against 2 x S. Printed, not held: cuBLAS picks
    its kernels by the row count either way; the fp32 sums leave a bf16
    result other bits only where another order of fp32 sums crosses a
    rounding boundary."""
    from repro_torch.models import xlstm
    from repro_torch.utils.tree import tree_map

    B, S = INVARIANT_SHAPE
    cfg, seg = model.cfg, model.segments[0]
    g = torch.Generator(device="cuda").manual_seed(11)
    x = torch.randn((B, S, cfg.d_model), generator=g, device="cuda").to(model.dtype)
    mixers = {kind: tree_map(lambda a: a[0], params["layers"][0][
        f"sub{[sp.mixer for sp in seg.specs].index(kind)}"]["mixer"]) for kind in ("mlstm", "slstm")}
    out = {}
    with torch.no_grad():
        for kind, p in mixers.items():
            apply = getattr(xlstm, f"{kind}_apply")
            out[f"one {kind} block"] = row_gap(apply(p, cfg, x, mode="train")[0],
                                               apply(p, cfg, x[:, :-1], mode="train")[0])
        batch = serving_prompt(cfg, B, S, seed=1)
        full = model.forward(params, batch, mode="train")[0]
        short = model.forward(params, prompt_slice(batch, slice(0, S - 1)), mode="train")[0]
        out["the whole model"] = row_gap(full, short)
        rows = x.reshape(B * S, -1)
        for wname, w in (("up", mixers["mlstm"]["up"]), ("ffn wi", mixers["slstm"]["ffn"]["wi"])):
            for how, mm in (("fp32 sums", xlstm._mm), ("plain bf16", torch.matmul)):
                ref = mm(rows, w)
                for n in (B * (S - 1), B):
                    out[f"{wname} {how} over {n} rows"] = row_gap(ref[None], mm(rows[:n], w)[None])
    for what, (rel, share) in out.items():
        print(f"  xlstm-350m row count, {what}: max gap {rel:.3e} of the largest value, "
              f"{share:.4%} of values other bits (over S - 1 = {S - 1} against S = {S})"
              if "rows" not in what else
              f"  xlstm-350m row count, {what} against {B * S}: {share:.4%} of values other "
              f"bits, max gap {rel:.3e}")
    return {k: {"max_rel_gap": v[0], "share_differing": v[1]} for k, v in out.items()}


def xlstm_block_invariant(label, model, params):
    """The first mLSTM and the first sLSTM block of ``model``
    (``block_invariant``) at INVARIANT_SHAPE over XLSTM_BLOCK_SEEDS, held to
    XLSTM_BLOCK_RTOL."""
    from repro_torch.models import xlstm
    from repro_torch.utils.tree import tree_map

    seg = model.segments[0]
    out = []
    for kind in ("mlstm", "slstm"):
        j = [s.mixer for s in seg.specs].index(kind)
        p = tree_map(lambda a: a[0], params["layers"][0][f"sub{j}"]["mixer"])
        apply = getattr(xlstm, f"{kind}_apply")

        def run(x, pos, cache, mode):
            return apply(p, model.cfg, x, cache=cache, mode=mode)

        out += block_invariant(label, f"one {kind} block (layer {j})", run, model.cfg.d_model,
                               model.dtype, INVARIANT_SHAPE, XLSTM_BLOCK_RTOL,
                               seeds=XLSTM_BLOCK_SEEDS)
    return out


def xlstm_seamless_serving_phase():
    """xLSTM-350M whole and SeamlessM4T-medium whole (4,096 frames), each
    drawn on the card from seed 0: one request through ``serve.generate``
    (``serving_lane``; flash 0 and 36 times a request), the prefill +
    decode == forward invariant (SeamlessM4T at full width in bf16 at
    INVARIANT_RTOL over INVARIANT_FRAMES frames; xLSTM's whole bf16 model at
    full width measured, one mLSTM and one sLSTM block there held at
    XLSTM_BLOCK_RTOL, the whole model in fp32 on fresh fp32 weights at
    XLSTM_FP32_INVARIANT_RTOL and in bf16 at the reduced width and full
    depth at XLSTM_INVARIANT_RTOL), a profiled prefill and decode step of
    each (flash launches counted in each: 36 and 0 for SeamlessM4T), and
    xLSTM's mLSTM and sLSTM ranges in a prefill; each model freed before the
    next."""
    from repro_torch.configs import get_config
    from repro_torch.models.transformer import TransformerLM

    print(f"  memory_allocated at the start {torch.cuda.memory_allocated() / 2**30:.2f} GiB")
    out = {"lanes": [], "invariant": [], "profile": {}, "models": []}
    for arch, n_flash in XLSTM_SEAMLESS_SERVING:
        t0 = time.perf_counter()
        cfg = get_config(arch)
        model = TransformerLM(cfg, device="cuda")
        params = model.init(0)
        torch.cuda.synchronize()
        init_s = time.perf_counter() - t0
        n_params = cfg.n_params()
        plan = [s.mixer + "/" + s.ffn + ("/cross" if s.cross else "") for s in model.plan]
        print(f"  {arch}: {n_params:,} params ({len(plan)} decoder layers: "
              f"{dict((k, plan.count(k)) for k in dict.fromkeys(plan))}; "
              f"{len(model.enc_plan)} encoder layers) drawn on the card from seed 0 in "
              f"{init_s:.2f} s; {torch.cuda.memory_allocated() / 2**30:.2f} GiB allocated")
        require(n_flash_layers(model) == n_flash,
                f"{arch}: {n_flash_layers(model)} flash layers, want {n_flash}")
        lane = serving_lane(arch, model, params)
        lane.update(params=n_params, layers=len(plan), encoder_layers=len(model.enc_plan),
                    init_s=init_s)
        out["lanes"].append(lane)
        if cfg.xlstm_pattern:
            b = XLSTM_SERVING_BEFORE
            print(f"  {arch}: prefill {lane['prefill_s']:.4f} s, decode "
                  f"{lane['decode_ms_per_token']:.3f} ms/token; before its bf16 products took "
                  f"fp32 sums and its chunkwise form one chunk size: prefill "
                  f"{b['prefill_s'][0]}-{b['prefill_s'][1]} s, decode "
                  f"{b['decode_ms_per_token'][0]}-{b['decode_ms_per_token'][1]} ms/token")
            out["invariant"].append(lm_invariant(arch, model, params,
                                                 rtol=XLSTM_INVARIANT_RTOL))
            out["invariant"] += xlstm_block_invariant(arch, model, params)
            out["xlstm_row_count"] = xlstm_row_count(model, params)
        else:
            out["invariant"].append(lm_invariant(arch, model, params))
        prof = profile_serving(arch, model, params)
        flash = {what: prof[what]["launches"].get("flash_attention", 0) for what in prof}
        require(flash == {"prefill": n_flash, "decode step": 0},
                f"{arch}: flash launches in the profiled prefill and decode step {flash}")
        out["profile"][arch] = prof
        if cfg.xlstm_pattern:
            out["xlstm_ranges"] = xlstm_prefill_ranges(model, params)
        out["models"].append({"arch": arch, "layers": len(plan),
                              "encoder_layers": len(model.enc_plan), "params": n_params,
                              "init_s": init_s})
        del model, params
        free_card()
        if cfg.xlstm_pattern:
            from repro_torch.configs.base import reduced

            for label, c, rtol in (
                    (f"{arch} fp32", dataclasses.replace(
                        cfg, param_dtype="float32", compute_dtype="float32"),
                     XLSTM_FP32_INVARIANT_RTOL),
                    (f"{arch} at the reduced width", reduced(
                        cfg, n_layers=cfg.n_layers, xlstm_pattern=cfg.xlstm_pattern,
                        param_dtype=cfg.param_dtype, compute_dtype=cfg.compute_dtype),
                     XLSTM_INVARIANT_RTOL)):
                model = TransformerLM(c, device="cuda")
                params = model.init(0)
                out["invariant"].append(lm_invariant(label, model, params, rtol=rtol))
                del model, params
                free_card()
    return out


def print_ptxas(log):
    """One line per compiled kernel: registers and spill stores."""
    entry, spill = "?", "?"
    for line in log.splitlines():
        if "Compiling entry function" in line:
            mangled = line.split("'")[1]
            for base in HAND_KERNELS:
                if base in mangled:
                    rest = mangled.split(base, 1)[1]
                    entry = base + ("<" + rest.split("EEv")[0][1:] + ">" if "EEv" in rest
                                    else "")
                    break
            else:
                entry = mangled
        elif "spill stores" in line:
            spill = line.strip().split(",")[1].strip()
        elif "Used" in line and "registers" in line:
            regs = line.split("Used", 1)[1].split(",")[0].strip()
            print(f"    {entry}: {regs}, {spill}")


def main() -> int:
    if not torch.cuda.is_available():
        print("chip_smoke: torch.cuda.is_available() is False: this script needs a CUDA card",
              file=sys.stderr)
        return 2

    from repro_torch.data.synthetic import make_image_classification
    from repro_torch.kernels.build import build_all

    t_start = time.perf_counter()
    phase("1. environment")
    smi = nvidia_smi_line()
    print(f"nvidia-smi: {smi}")
    print(f"torch {torch.__version__}, CUDA {torch.version.cuda}, python {sys.version.split()[0]}")
    kind = torch.cuda.get_device_name(0)
    print(f"device: {kind} (count {torch.cuda.device_count()})")
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    print(f"allow_tf32: matmul={torch.backends.cuda.matmul.allow_tf32} "
          f"cudnn={torch.backends.cudnn.allow_tf32}")

    phase("2. build (one nvcc per source, all at once)")
    t0 = time.perf_counter()
    built = build_all(["fedavg_agg", "quantized_agg", "sparse_agg", "gossip_mix",
                       "flash_attention", "ssm_scan", "ce_loss"])
    print(f"built in {time.perf_counter() - t0:.2f} s wall")
    for src, res in built.items():
        print(f"  {src}: {res.path.name} nvcc {res.seconds:.2f} s (cached={res.cached})")
        print_ptxas(res.log)
    from repro_torch.kernels.flash_attention import MMA_HEAD_DIMS, mma_occupancy

    mma_resources = {D: mma_occupancy(D) for D in MMA_HEAD_DIMS}
    for D, r in mma_resources.items():
        print(f"  flash_fwd_mma_kernel<{D}>: {r['threads']} threads, {r['smem_bytes']} bytes of "
              f"dynamic shared memory a block, {r['blocks_per_sm']} blocks an SM "
              f"(cudaOccupancyMaxActiveBlocksPerMultiprocessor)")
    from repro_torch.kernels.ce_loss import mma_occupancy as ce_mma_occupancy

    ce_resources = ce_mma_occupancy()
    print(f"  ce_fwd_mma_kernel and ce_probs_mma_kernel: {ce_resources['threads']} threads, "
          f"{ce_resources['smem_bytes']} bytes of dynamic shared memory a block, "
          f"{ce_resources['blocks_per_sm']} blocks an SM (the forward's occupancy query)")

    phase("3. kernel vs plain on the card")
    errs = {
        "fedavg_aggregate": check_fedavg_aggregate(),
        "quantized_aggregate": check_quantized_aggregate(),
        "packed_quantized_aggregate": check_packed_quantized_aggregate(),
        "sparse_aggregate": check_sparse_aggregate(),
        "gossip_mix": check_gossip_mix(),
        "flash_attention": check_flash_attention(),
        "ssm_scan": check_ssm_scan(),
        "fused_cross_entropy": check_fused_cross_entropy(),
        "ce_probs": check_ce_probs(),
        "ssm_scan_bwd": check_ssm_scan_bwd(),
    }
    flash_lse_err = check_flash_lse()
    flash_train_err = check_flash_training()
    check_grad_guard()

    phase("4. timing (CUDA events, median of 200, L2 flushed to clean lines before each "
          "launch)")
    print(f"card: {smi}")
    timing = {"fedavg_aggregate": {
        **time_fedavg_aggregate(), "gemma-2b train leaves": time_fedavg_training_leaves(),
        **{f"{arch} ({n} layers) train leaves": time_fedavg_training_leaves(arch, n, iters=20)
           for arch, n in MLA_VISION_TRAIN}},
              **time_wire_kernels(),
              "gossip_mix": time_gossip_mix(),
              # the scan's microsecond decode rows before flash's long scalar
              # turns (V3's ~60 ms launches), not right after them
              "ssm_scan": time_ssm_scan(), "flash_attention": time_flash_attention()}
    timing["fused_cross_entropy"], timing["ce_probs"] = time_fused_cross_entropy()
    timing["ssm_scan_bwd"] = time_ssm_scan_bwd()

    phase("data: synthetic MNIST, 60,000 train / 10,000 test, seed 0")
    t0 = time.perf_counter()
    train, test, _ = make_image_classification(60_000, 10_000, seed=0)
    print(f"  made in {time.perf_counter() - t0:.2f} s")

    phase("5. main path: MNIST 2NN, non-IID")
    launches_2nn, wall_2nn, eng_2nn = main_path("mnist_2nn", (train, test))
    phase("6. main path: MNIST CNN, non-IID")
    launches_cnn, wall_cnn, eng_cnn = main_path("mnist_cnn", (train, test))

    phase("7. where the time goes: one more round of each, under torch.profiler")
    for name, eng in (("mnist_2nn", eng_2nn), ("mnist_cnn", eng_cnn)):
        profile_round(name, eng, "fedavg_agg", "fedavg_aggregate")
    del eng_2nn, eng

    phase("8. the compressed-upload lane, full size, through RoundEngine(codec=...).run")
    lanes, eng_cnn_q8 = [], None
    for model_name, spec_name, override, kernel in LANES:
        lane, eng = compressed_lane(model_name, spec_name, override, kernel, (train, test))
        lanes.append(lane)
        if model_name == "mnist_cnn" and lane["codec"] == "q8":
            eng_cnn_q8 = eng
        del eng
    for lane in lanes:
        print(f"  {lane['model']} {lane['codec']:8s}: "
              + (f"{lane['launches']} launches of {lane['kernel']}" if lane["kernel"]
                 else "no hand kernel")
              + f" in {lane['rounds']} rounds, rounds "
              + ", ".join(f"{t:.4f}" for t in lane["round_wall_s"]) + " s, payload "
              f"{lane['payload_bytes']} B of {lane['dense_bytes']} dense")

    phase("9. where the time goes in the compressed lane: one more CNN q8 round")
    reset_counts()
    profile_round("mnist_cnn q8", eng_cnn_q8, "qagg_stream_kernel<", "quantized_aggregate")
    require_main_route("mnist_cnn q8 profiled round", "quantized_aggregate")

    phase("10. plain and q8 CNN rounds in turns (plain, q8), host clock to the synced loss")
    turns = []
    reset_counts()
    for name, eng in (("plain", eng_cnn), ("q8", eng_cnn_q8)):
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        float(eng.round()["loss"])
        turns.append((name, time.perf_counter() - t0))
        print(f"  {name:5s} round {turns[-1][1]:.4f} s")
    require(launch_counts()["quantized_aggregate"] == 1, "one q8 round, one launch")
    require_main_route("plain and q8 CNN rounds in turns", "quantized_aggregate")
    del eng_cnn, eng_cnn_q8, eng

    phase("11. the gossip lane, full size, through RoundEngine(topology=...).run")
    gossip, eng_cnn_ring = [], None
    for model_name, spec_name in GOSSIP_LANES:
        lane, eng = gossip_lane(model_name, spec_name, (train, test))
        gossip.append(lane)
        if model_name == "mnist_cnn":
            eng_cnn_ring = eng
        del eng
    for lane in gossip:
        walls = ", ".join(f"{t:.4f}" for t in lane["round_wall_s"])
        print(f"  {lane['model']} {lane['spec']}: {lane['launches']} launches of gossip_mix in "
              f"{lane['rounds']} rounds, rounds {walls} s, consensus "
              + ", ".join(f"{c:.6f}" for c in lane["consensus"])
              + f", test_acc {lane['test_acc'][-1]:.4f}, peak device memory "
              f"{lane['peak_device_MiB']:.0f} MiB")

    phase("12. the anchor: full graph == FedAvg with C = 1.0 (2NN, 100 nodes)")
    anchor_res = anchor((train, test))

    phase("13. where the time goes in the gossip lane: one more CNN ring round")
    gossip_profile = profile_round("mnist_cnn ring", eng_cnn_ring, "gossip_mix_",
                                   "gossip_mix")   # either route's kernel
    del eng_cnn_ring

    from repro_torch.configs import get_config
    from repro_torch.models.transformer import TransformerLM

    phase(f"14. serving Jamba: {JAMBA_LAYERS} layers at full width, bf16, B={SERVE_BATCH}, "
          f"prompt {PROMPT}, {SERVE_TOKENS} tokens, through repro_torch.launch.serve.generate")
    t0 = time.perf_counter()
    jamba = TransformerLM(dataclasses.replace(get_config("jamba-v0.1-52b"),
                                              n_layers=JAMBA_LAYERS), device="cuda")
    jamba_params = jamba.init(0)
    torch.cuda.synchronize()
    print(f"  {jamba.cfg.n_params():,} params ({len(jamba.plan)} layers: "
          f"{[s.mixer + '/' + s.ffn for s in jamba.plan]}) drawn on the card from seed 0 in "
          f"{time.perf_counter() - t0:.2f} s")
    serving = [serving_lane("jamba", jamba, jamba_params)]

    phase("15. serving Gemma-2B: all 18 layers, bf16, the same traffic")
    t0 = time.perf_counter()
    gemma = TransformerLM(get_config("gemma-2b"), device="cuda")
    gemma_params = gemma.init(0)
    torch.cuda.synchronize()
    print(f"  {gemma.cfg.n_params():,} params drawn on the card from seed 0 in "
          f"{time.perf_counter() - t0:.2f} s")
    serving.append(serving_lane("gemma-2b", gemma, gemma_params))

    phase("16. correctness of the LM path on the card")
    invariant = [lm_invariant("jamba", jamba, jamba_params),
                 lm_invariant("gemma-2b", gemma, gemma_params)]
    del gemma, gemma_params
    card_vs_cpu = [reduced_card_vs_cpu(arch) for arch in (
        "jamba-v0.1-52b", "gemma-2b", "deepseek-v2-lite-16b", "deepseek-v3-671b", "qwen2-vl-7b",
        "xlstm-350m", "seamless-m4t-medium")]

    phase("17. where the time goes serving Jamba: one prefill and one decode step, "
          "under torch.profiler")
    serving_profile = profile_serving("jamba", jamba, jamba_params)
    del jamba, jamba_params
    free_card()

    phase(f"18. training Gemma-2B: all 18 layers, bf16, remat, FedAvg G={TRAIN_G} x H={TRAIN_H} "
          f"AdamW steps on {TRAIN_B} x {TRAIN_S} tokens a group, 2 rounds, then 4 FedSGD steps, "
          "through repro_torch.launch.train.main")
    training = training_lane()

    phase("19. correctness of the training path on the card")
    train_checks = {"reduced_card_vs_cpu": [
        reduced_round_card_vs_cpu(arch) for arch in (
            "gemma-2b", "qwen2-72b", "jamba-v0.1-52b", "xlstm-350m", "seamless-m4t-medium",
            "deepseek-v2-lite-16b", "deepseek-v3-671b", "qwen2-vl-7b")]}
    free_card()
    train_checks["full_width"] = full_width_ce_checks()
    free_card()

    phase("20. where the time goes training: one group step of Gemma-2B under torch.profiler")
    train_profile = profile_training_step()
    free_card()

    phase("data: the Shakespeare spec's corpus, make_char_corpus() at its 1146 roles")
    chars = shakespeare_data()

    phase("21. the spec front door and checkpoints, full size, through "
          "RoundEngine.from_spec(get_spec(name), ...).run and save/restore")
    spec_lanes, resumes, lm_ckpt = spec_front_door(train, test, chars)

    phase(f"22. the superstep lane, full size, through RoundEngine(..., device_sampling=True)"
          f".run(n, rounds_per_step={SUPERSTEP_R}): one round captured as a CUDA graph")
    print(f"card: {smi}")
    superstep_lanes, superstep_spec_lane = superstep_phase(train, test)

    phase("23. the paper's other models, full size: the CIFAR CNN through FederatedTrainer, "
          "the word-LSTM through RoundEngine, the Shakespeare example, card vs CPU")
    print(f"card: {smi}")
    paper_models = paper_models_phase(chars)
    del chars

    phase("24. the buffered-async lane and the streamed pool, full size, through "
          "RoundEngine(async_config=, latency=, pool=).run")
    print(f"card: {smi}")
    async_streamed = async_streamed_phase(train, test)

    phase("25. cohort sharding, full size, through RoundEngine(mesh=make_client_mesh()).run: "
          "the partial-sum kernels, an NCCL world of one, the captured superstep, three "
          "gloo ranks on the card, from_spec")
    print(f"card: {smi}")
    sharding = cohort_shard_phase(train, test)

    phase("26. supersteps off the star lanes, full size: the gossip superstep through "
          "gossip_mix, low-rank under device sampling, the streamed pool's staged superstep, "
          "from_spec")
    print(f"card: {smi}")
    offstar = offstar_superstep_phase(train, test)

    phase(f"27. training Jamba: full width cut to {JAMBA_TRAIN_LAYERS} layers (Mamba/MLP, "
          f"Mamba/MoE), bf16, remat, FedAvg G={TRAIN_G} x H={TRAIN_H} AdamW steps (bf16 "
          f"moments) on {TRAIN_B} x {TRAIN_S} tokens a group, 2 rounds, through "
          "repro_torch.launch.train.run; then one profiled group step")
    print(f"card: {smi}")
    jamba_training = jamba_training_phase()
    free_card()

    phase(f"28. serving MLA and the vision stub: DeepSeek-V2-Lite whole, DeepSeek-V3 at full "
          f"width cut to 4 layers, Qwen2-VL-7B whole, bf16, B={SERVE_BATCH}, prompt {PROMPT}, "
          f"{SERVE_TOKENS} tokens, through repro_torch.launch.serve.generate")
    print(f"card: {smi}")
    mla_vision = mla_vision_serving_phase()
    serving += mla_vision["lanes"]
    invariant += mla_vision["invariant"]

    phase(f"29. serving xLSTM-350M whole (24 blocks) and SeamlessM4T-medium whole (12 + 12 "
          f"layers over {SEAMLESS_FRAMES} frames), bf16, B={SERVE_BATCH}, prompt {PROMPT}, "
          f"{SERVE_TOKENS} tokens, through repro_torch.launch.serve.generate")
    print(f"card: {smi}")
    xlstm_seamless = xlstm_seamless_serving_phase()
    serving += xlstm_seamless["lanes"]
    invariant += xlstm_seamless["invariant"]
    free_card()

    phase(f"30. training xLSTM-350M and SeamlessM4T-medium whole, bf16, remat, FedAvg "
          f"G={TRAIN_G} x H={TRAIN_H} AdamW steps (fp32 moments) on {TRAIN_B} x {TRAIN_S} "
          "tokens a group, one round, through repro_torch.launch.train.run; then one profiled "
          "group step of SeamlessM4T and xLSTM's sLSTM layer alone")
    print(f"card: {smi}")
    archs_training = archs_training_phase()
    free_card()

    phase(f"31. training MLA + MoE and the vision stub: DeepSeek-V2-Lite at full width cut to "
          f"{MLA_VISION_TRAIN[0][1]} layers, Qwen2-VL-7B at full width cut to "
          f"{MLA_VISION_TRAIN[1][1]} layers, bf16, remat, FedAvg G={TRAIN_G} x H={TRAIN_H} "
          f"AdamW steps (bf16 moments) on {TRAIN_B} x {TRAIN_S} tokens a group, one round, "
          "through repro_torch.launch.train.run; then one profiled group step each")
    print(f"card: {smi}")
    mla_vision_training = mla_vision_training_phase()

    phase("summary")
    launches = {"fedavg_aggregate": launches_2nn + launches_cnn}
    for k in WIRE_KERNELS:
        launches[k] = sum(lane["launches"] for lane in lanes if lane["kernel"] == k)
    launches["gossip_mix"] = sum(lane["launches"] for lane in gossip)
    for lane in spec_lanes:
        if lane["kernel"]:
            launches[lane["kernel"]] += lane["launches"]
    for lane in superstep_lanes:
        launches[lane["kernel"]] += lane["launches"]
    launches["fedavg_aggregate"] += superstep_spec_lane["launches"]
    launches["fedavg_aggregate"] += sum(paper_models[m]["launches"]
                                        for m in ("cifar_cnn", "word_lstm"))
    for k, n in async_streamed["launches"].items():
        launches[k] += n
    for k, n in sharding["partial_launches"].items():
        launches[k] += n
    for k, n in offstar["launches"].items():
        launches[k] += n
    for k in ("flash_attention", "ssm_scan"):
        launches[k] = sum(lane["launches"][k] for lane in serving)
    for k in ("ssm_scan", "ssm_scan_bwd", "fused_cross_entropy", "ce_probs", "fedavg_aggregate"):
        launches[k] = launches.get(k, 0) + jamba_training["lane"]["launches"][k]
    for k in ("fedavg_aggregate", "flash_attention", "fused_cross_entropy", "ce_probs"):
        launches[k] = (launches.get(k, 0) + sum(run["launches"][k] for run in training.values())
                       + archs_training["launches"][k] + mla_vision_training["launches"][k])
    arch_lanes = [a["lane"] for a in list(archs_training["archs"].values())
                  + list(mla_vision_training["archs"].values())]
    flash_tc = (sum(lane["flash_tc_launches"] for lane in serving)
                + sum(run["flash_tc_launches"] for run in training.values())
                + sum(lane["tc_launches"]["flash_attention"] for lane in arch_lanes))
    ce_tc = (sum(run["ce_tc_launches"] for run in training.values())
             + sum(lane["tc_launches"]["fused_cross_entropy"] for lane in arch_lanes))
    sources = {
        "fedavg_aggregate": ("fedavg_agg.cu", "src/repro/kernels/fedavg_agg.py:77"),
        "quantized_aggregate": ("quantized_agg.cu", "src/repro/kernels/quantized_agg.py:81"),
        "packed_quantized_aggregate": ("quantized_agg.cu",
                                       "src/repro/kernels/quantized_agg.py:215"),
        "sparse_aggregate": ("sparse_agg.cu", "src/repro/kernels/sparse_agg.py:75"),
        "gossip_mix": ("gossip_mix.cu", "src/repro/kernels/gossip_mix.py:85"),
        "flash_attention": ("flash_attention.cu", "src/repro/kernels/flash_attention.py:111"),
        "ssm_scan": ("ssm_scan.cu", "src/repro/kernels/ssm_scan.py:62"),
        "fused_cross_entropy": ("ce_loss.cu", "src/repro/kernels/ce_loss.py:91"),
        # no Pallas kernel: the reference's CE gradient is XLA's autodiff of
        # the chunk's logits
        "ce_probs": ("ce_loss.cu", "src/repro/models/transformer.py:363"),
        # no Pallas kernel: the reference trains Mamba through a plain
        # lax.scan (_segmented_scan), which XLA differentiates
        "ssm_scan_bwd": ("ssm_scan.cu", "src/repro/models/ssm.py:25"),
    }
    at = {
        "fedavg_aggregate": {"K": MAIN_K, "N": MAIN_N["mnist_cnn"], "dtype": "float32"},
        "quantized_aggregate": {"K": MAIN_K, "N": MAIN_N["mnist_cnn"], "codes": "uint8",
                                "chunk": CHUNK},
        "packed_quantized_aggregate": {"K": MAIN_K, "N": MAIN_N["mnist_cnn"], "bits": 4,
                                       "chunk": CHUNK},
        "sparse_aggregate": {"K": MAIN_K, "n": MAIN_N["mnist_cnn"], "keep_frac": TOPK,
                             "vals": "float32"},
        "gossip_mix": {"n": N_NODES, "N": MAIN_N["mnist_cnn"], "plan": "ring", "max_slots": 3,
                       "dtype": "float32"},
        "flash_attention": {"shape": "jamba prefill", "B": SERVE_BATCH, "S": PROMPT, "H": 32,
                            "K": 8, "D": 128, "dtype": "bfloat16", "causal": True},
        "ssm_scan": {"shape": "jamba prefill", "B": SERVE_BATCH, "T": PROMPT, "D": SSM_D,
                     "N": SSM_N, "dtype": "float32"},
        "fused_cross_entropy": {"shape": "gemma-2b train step", "T": CE_SHAPE[0],
                                "d": CE_SHAPE[1], "V": CE_SHAPE[2], "dtype": "bfloat16",
                                "head": "tied view"},
        "ce_probs": {"shape": "gemma-2b train step, one backward chunk", "T": CE_CHUNK_TOKENS,
                     "d": CE_SHAPE[1], "V": CE_SHAPE[2], "dtype": "bfloat16",
                     "head": "tied view"},
        "ssm_scan_bwd": {"shape": "jamba train step, one Mamba layer", "B": SSM_TRAIN_B,
                         "T": TRAIN_S, "D": SSM_D, "N": SSM_N, "dtype": "float32"},
    }
    main_shape = {k: "mnist_cnn" for k in KERNELS}
    main_shape.update(gossip_mix="ring/mnist_cnn", flash_attention="jamba",
                      ssm_scan="jamba/prefill", fused_cross_entropy="gemma-2b train",
                      ce_probs="gemma-2b train chunk", ssm_scan_bwd="jamba/train")
    lanes_of = {"flash_attention": serving, "ssm_scan": serving,
                "fused_cross_entropy": [],   # their lane is kernels[7]["training"]
                "ce_probs": [],
                "ssm_scan_bwd": []}          # its lane is kernels[9]["training"]
    kernels = []
    for k in KERNELS:
        cnn = timing[k][main_shape[k]]
        kernels.append({
            "name": k,
            "route": "cuda",
            "source": f"src/repro_torch/kernels/csrc/{sources[k][0]}",
            "replaces": sources[k][1],
            "launches": launches[k],
            "max_abs_err": errs[k],
            "ms": cnn["ms"],
            "plain_ms": cnn["plain_ms"],
            "bound_ms": cnn["bound_ms"],
            "bound_by": cnn["bound_by"],
            "library_ms": cnn["library_ms"],
            "at": at[k],
            "per_shape": timing[k],
            "lanes": lanes_of.get(k, [lane for lane in lanes + gossip if lane["kernel"] == k]),
        })
    kernels[0]["round_wall_s"] = {"mnist_2nn": wall_2nn, "mnist_cnn": wall_cnn}
    for k in kernels:
        k["spec_lanes"] = [lane for lane in spec_lanes if lane["kernel"] == k["name"]]
    kernels[0]["spec_front_door"] = {"resume": resumes,
                                     "lm_checkpoint": lm_ckpt,
                                     "lowrank": [lane for lane in spec_lanes
                                                 if lane["kernel"] is None]}
    for i, k in enumerate(PARTIAL_KERNELS):
        kernels[i]["partial_sum"] = {
            "launches": sharding["partial_launches"][k],
            "max_abs_err": sharding["errs"][k],
            "lanes": [lane for lane in sharding["lanes"] + sharding["gloo"]["lanes"]
                      if lane["kernel"] == k]}
    kernels[0]["partial_sum"].update(superstep=sharding["superstep"],
                                     from_spec=sharding["from_spec"],
                                     gloo_wall_s=sharding["gloo"]["wall_s"])
    kernels[0]["paper_models"] = paper_models
    kernels[0]["async_and_streamed"] = async_streamed
    kernels[0]["superstep"] = {"lanes": [l for l in superstep_lanes
                                         if l["kernel"] == "fedavg_aggregate"],
                               "spec": superstep_spec_lane,
                               "staged": offstar["streamed"],
                               "staged_population": offstar["population"],
                               "lowrank": offstar["lowrank"],
                               "from_spec": offstar["from_spec"],
                               "phase_26_launches": offstar["launch_sources"][
                                   "fedavg_aggregate"]}
    for i in (1, 3):
        kernels[i]["superstep"] = [l for l in superstep_lanes if l["kernel"] == KERNELS[i]]
    kernels[1]["cnn_rounds_in_turns_s"] = turns
    kernels[4]["anchor"] = anchor_res
    kernels[4]["cnn_ring_round_profile"] = gossip_profile
    for i in (1, 2):
        kernels[i]["routes"] = {
            "stream": "qagg_stream_kernel (uint8/uint16 codes, words at bits 1/2/4; chunk a "
                      "whole number of 16-byte granules, >= 64 bytes; aligned; K <= 32)",
            "general": "qagg_kernel / packed_qagg_kernel (the rest)"}
        stream = sum(lane["main_route_launches"] for lane in lanes + spec_lanes
                     if lane["kernel"] == KERNELS[i]) + sum(
            lane["launches"] for lane in superstep_lanes if lane["kernel"] == KERNELS[i]) \
            + async_streamed["main_route_launches"].get(KERNELS[i], 0) \
            + offstar["launches"].get(KERNELS[i], 0)
        kernels[i]["route_launches"] = {"stream": stream,
                                        "general": launches[KERNELS[i]] - stream}
    kernels[3]["routes"] = {
        "fused": "sparse_agg_fused_kernel (k % 4 == 0; idx, fp32 vals and out 16-byte "
                 "aligned, bf16 vals 8-byte aligned): one cooperative launch zeroes and "
                 "scatters",
        "scatter": "a fill, then sparse_agg_kernel (the rest)"}
    fused = sum(lane["main_route_launches"] for lane in lanes + spec_lanes
                if lane["kernel"] == KERNELS[3]) + sum(
        lane["launches"] for lane in superstep_lanes if lane["kernel"] == KERNELS[3])
    kernels[3]["route_launches"] = {"fused": fused, "scatter": launches[KERNELS[3]] - fused}
    kernels[4]["routes"] = {
        "gather": "gossip_mix_kernel (D * DENSE_NODES_PER_SLOT < n: the ring, the small world)",
        "dense": "gossip_mix_dense_kernel (the rest: the full graph)"}
    dense = sum(lane["dense_launches"] for lane in gossip) + offstar["gossip_dense_launches"]
    kernels[4]["route_launches"] = {"gather": launches["gossip_mix"] - dense, "dense": dense,
                                    "dense in the anchor (phase 12)": 1}
    kernels[4]["superstep"] = {"lanes": offstar["gossip"],
                               "phase_26_launches": offstar["launch_sources"]["gossip_mix"]}
    from repro_torch.kernels.ssm_scan import launch_plan

    kernels[6]["routes"] = {
        f"{k} lanes": f"ssm_scan_ring_kernel with {k} lanes a channel" for k in (1, 2, 4)}
    kernels[6]["routes"]["plan"] = {"prefill": launch_plan(PROMPT), "decode": launch_plan(1)}
    kernels[6]["route_launches"] = {
        f"{k} lanes": sum(lane["ssm_lane_launches"][k] for lane in serving) for k in (1, 2, 4)}
    kernels[5]["invariant"] = invariant
    kernels[5]["reduced_card_vs_cpu"] = card_vs_cpu
    kernels[6]["jamba_profile"] = serving_profile
    kernels[5]["lse_max_rel_err"] = flash_lse_err
    kernels[5]["training_shapes_grad_rel_err"] = flash_train_err
    kernels[5]["xlstm_row_count"] = xlstm_seamless["xlstm_row_count"]
    kernels[7]["archs_training"] = archs_training["archs"]
    kernels[7]["mla_vision_training"] = mla_vision_training["archs"]
    kernels[5]["tc_launches"] = flash_tc
    kernels[5]["mla_vision_serving"] = {"models": mla_vision["models"],
                                        "profile": mla_vision["profile"]}
    kernels[5]["xlstm_seamless_serving"] = {"models": xlstm_seamless["models"],
                                            "profile": xlstm_seamless["profile"],
                                            "xlstm_ranges": xlstm_seamless["xlstm_ranges"]}
    kernels[5]["routes"] = {"mma": "flash_fwd_mma_kernel (bf16, D 64/128/192/256, aligned rows)",
                            "scalar": "flash_fwd_kernel (the rest)"}
    kernels[5]["mma_resources"] = mma_resources
    kernels[7]["tc_launches"] = ce_tc
    kernels[7]["routes"] = {"mma": "ce_fwd_mma_kernel (bf16, d % 8 == 0, aligned rows)",
                            "scalar": "ce_partial_kernel (the rest)"}
    kernels[7]["mma_resources"] = ce_resources
    kernels[7]["training"] = {algo: {"records": run["records"], "peak_GiB": run["peak_GiB"]}
                              for algo, run in training.items()}
    kernels[7]["training_checks"] = train_checks
    kernels[7]["training_step_profile"] = train_profile
    kernels[9]["training"] = jamba_training
    kernels[6]["training_launches"] = jamba_training["lane"]["launches"]["ssm_scan"]
    print(f"\nchip_smoke: all phases passed in {time.perf_counter() - t_start:.1f} s")
    print(smi)
    print(json.dumps({"kernels": kernels}))
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": kind, "count": torch.cuda.device_count()}}))
    return 0


if __name__ == "__main__":
    sys.exit(main())
