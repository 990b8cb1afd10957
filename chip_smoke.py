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
   Gemma-2B training leaves (11 bf16 launches of K = 2 a group average);
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
10. plain and q8 CNN rounds in turns, so that the two lanes' round times
    are compared on one card at one time;
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
    against the CPU;
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
    card against the CPU (Gemma-2B and Qwen2; SGD's update, AdamW's
    moments), ``train_loss``'s CE at full
    width against materialized fp32 logits, and FusedCrossEntropy's
    gradients against autograd through them;
20. one profiled Gemma-2B training step: device busy, idle share, the top
    kernels and the shares of the CE kernels (forward and ``ce_probs``), the
    flash kernel and the two backwards.

Phases 3 and 4 hold and time ``flash_attention``, ``ssm_scan``,
``fused_cross_entropy`` and ``ce_probs`` too, at the serving and training
shapes; phase 3 also holds the flash kernel's ``lse`` output and checks that
every kernel wrapper refuses an input that requires grad.
``flash_attention`` and ``fused_cross_entropy`` have two routes each, a
tensor-core kernel (bf16 on aligned rows; flash at D = 64, 128, 256) and a
scalar one (everything else): phase 3 checks which route each case took
(``tc_launches`` beside ``launches``) and runs every bf16 CE case on both;
phase 4 times both routes in turns at the main shapes and requires the
tensor-core route to be at least 5x faster, and times the CE backward
against the plain one it replaced; phases 14-15, 18 and 20 require every
flash and CE launch of the serving and training paths to take the
tensor-core route. ``gossip_mix`` has two routes too, the gather kernel
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
(the CE gradient's kernel) ports no Pallas kernel; it is held, timed and
counted like the eight that do. Every
kernel's launch count is set to 0 just before each lane's run and read just
after. Each phase prints its seconds.
The last three lines are the card's ``nvidia-smi`` name and power limit, a
``{"kernels": [...]}`` record and ``{"ok": true, "device": {...}}``. Any failure exits non-zero
before those lines; so does a machine without a card.
"""
from __future__ import annotations

import dataclasses
import gc
import json
import math
import subprocess
import sys
import time
from pathlib import Path

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

# The eight ported TPU kernels, then ce_probs: the CE gradient's kernel on the
# training path, which ports no Pallas kernel (the reference's CE gradient is
# XLA's autodiff).
KERNELS = ("fedavg_aggregate", "quantized_aggregate", "packed_quantized_aggregate",
           "sparse_aggregate", "gossip_mix", "flash_attention", "ssm_scan",
           "fused_cross_entropy", "ce_probs")
WIRE_KERNELS = KERNELS[1:4]             # the compressed lane's
CHUNK = 512                             # the specs' quantize chunk
TOPK = 0.05                             # specs/mnist_2nn_noniid_topk.json
COMPRESSED_ROUNDS = 2
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
GOSSIP_ROUNDS = 2
# (model, spec whose topology, fedavg and partition sections the lane uses);
# no CNN gossip spec exists, so the CNN takes the 2NN ring spec's sections.
GOSSIP_LANES = (
    ("mnist_2nn", "mnist_2nn_noniid_ring"),
    ("mnist_2nn", "mnist_2nn_noniid_smallworld"),
    ("mnist_cnn", "mnist_2nn_noniid_ring"),
)
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
# flash_attention's two prefill shapes (B, S, H, K, D) and Jamba's scan
# (d_inner 8192, d_state 16)
FLASH_SHAPES = {"jamba": (SERVE_BATCH, PROMPT, 32, 8, 128),
                "gemma-2b": (SERVE_BATCH, PROMPT, 8, 1, 256),
                "gemma-2b train": (2, 2048, 8, 1, 256)}
FLASH_WINDOW = 100
SSM_D, SSM_N = 8192, 16
# The prefill+decode == forward invariant at full width in bf16, at a size
# where Jamba's MoE buffers at capacity factor 8 fit. A bf16 value holds 8
# significant bits (2^-8 = 0.4%), and the two paths round at other places
# through every layer's residual stream: the logits are held to 2^-5 (3.1%)
# of their largest magnitude.
INVARIANT_SHAPE = (2, 128)
INVARIANT_RTOL = 2.0 ** -5
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
# The card's fp32 round against the CPU's: sums in other orders through two
# layers and back, in the SGD update and in AdamW's moments.
TRAIN_RTOL = 1e-4
# The kernel's CE against fp32 logits materialized from the same bf16 hidden:
# two fp32 sums of 2048 products and of 256,000 exponentials in other orders.
CE_MATERIALIZED_RTOL = 1e-5
# FusedCrossEntropy's bf16 gradients against autograd through materialized
# fp32 logits, rounded to bf16 alike.
CE_GRAD_RTOL = 1e-3


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
            if c["K"] == MAIN_K and c["N"] in MAIN_N.values() and not tag:
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
        print(f"  K={c['K']:2d} N={c['N']:8d} {str(c['dtype'])[6:]:8s} vec={vec}{tag}: "
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
    from repro_torch.kernels.ssm_scan import ssm_scan
    from repro_torch.kernels.ce_loss import ce_probs, fused_cross_entropy

    return {f.__name__: f for f in (fedavg_aggregate, quantized_aggregate,
                                    packed_quantized_aggregate, sparse_aggregate, gossip_mix,
                                    flash_attention, ssm_scan, fused_cross_entropy, ce_probs)}


def launch_counts():
    return {name: f.launches for name, f in counters().items()}


def reset_counts():
    for f in counters().values():
        f.launches = 0
    for name in ("flash_attention", "fused_cross_entropy", "ce_probs"):
        counters()[name].tc_launches = 0
    counters()["gossip_mix"].dense_launches = 0
    for name in ("quantized_aggregate", "packed_quantized_aggregate"):
        counters()[name].stream_launches = 0
    counters()["sparse_aggregate"].fused_launches = 0
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
    for model, N in MAIN_N.items():
        x, w = make_case(MAIN_K, N, torch.float32, seed=7)
        nbytes = MAIN_K * N * 4 + N * 4 + MAIN_K * 4
        flops = 2 * MAIN_K * N
        bound = max(nbytes / HBM_BYTES_PER_S, flops / FP32_FLOPS) * 1e3
        r = {
            "K": MAIN_K, "N": N, "dtype": "float32",
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
        print(f"  {model}: K={MAIN_K} N={N} fp32 vec={r['vec']} kernel_ms={r['ms']:.5f} "
              f"bound_ms={bound:.5f} ({r['bound_share']:.1%} of bound, "
              f"{r['achieved_GBps']:.0f} GB/s) plain_ms={r['plain_ms']:.5f} "
              f"library_ms={r['library_ms']:.5f} (torch.mv, yardstick only)")
    del flush
    return rows


def time_fedavg_training_leaves():
    """``fedavg_aggregate`` as one Gemma-2B group average launches it
    (``ops.tree_weighted_mean``: K = TRAIN_G groups, each bf16 leaf viewed
    (K, -1), equal weights), on zero-filled stacks of the leaves' real
    shapes: each leaf's time, their sum and the largest leaf's, against the
    bound (the leaves' bytes, each read once and the average written once,
    over the HBM rate) and a one-call yardstick, ``torch.mv`` on the bf16
    (N, K) view with bf16 weights (cuBLAS sums in fp32; 1 / K is exact in
    bf16 at K = 2)."""
    from repro_torch.configs import get_config
    from repro_torch.kernels.fedavg_agg import fedavg_aggregate
    from repro_torch.models.transformer import TransformerLM
    from repro_torch.utils.tree import tree_leaves

    flush = flush_buffer()
    K = TRAIN_G
    w = torch.full((K,), 1.0 / K, device="cuda")
    w16 = w.to(torch.bfloat16)
    require(torch.equal(w16.float(), w), "the group weights round in bf16")
    shapes = [tuple(p.shape) for p in tree_leaves(
        TransformerLM(get_config("gemma-2b"), device="meta").param_shapes())]
    leaves = []
    for shape in shapes:
        x = torch.zeros((K, math.prod(shape)), dtype=torch.bfloat16, device="cuda")
        leaves.append({"shape": shape, "N": x.shape[1],
                       "ms": time_ms(lambda: fedavg_aggregate(x, w), flush, iters=50, warmup=5),
                       "library_ms": time_ms(lambda: torch.mv(x.t(), w16), flush, iters=50,
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
    print(f"  gemma-2b training leaves: {len(leaves)} launches (K={K} bf16, zero-filled), "
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
             for dtype in (torch.float32, torch.bfloat16) for D in (64, 128, 256)
             for S in (1, 37, 130, 2047) for H, K in ((32, 8), (8, 1))
             for mask in ("causal", "full", "window")]
    cases += [dict(B=B, S=S, H=H, K=K, D=D, dtype=torch.bfloat16, mask="causal", main=tag)
              for tag, (B, S, H, K, D) in FLASH_SHAPES.items()]
    before = flash_attention.launches
    main_err, worst = 0.0, {torch.float32: 0.0, torch.bfloat16: 0.0}
    for i, c in enumerate(cases):
        q, k, v = flash_inputs(c["B"], c["S"], c["S"], c["H"], c["K"], c["D"], c["dtype"], i)
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
        print(f"  B={c['B']} S={c['S']:4d} H/K={c['H']}/{c['K']} D={c['D']:3d} "
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
    for dtype, route in ((torch.float32, "scalar"), (torch.bfloat16, "mma")):
        qkv = torch.randn((2, 130, 8 * 64), device="cuda").to(dtype)
        qs, ks, vs = (qkv[..., a * 64:b * 64].view(2, 130, b - a, 64)
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
    print(f"  (BH, S, D) layout, D=37, window 9: max_abs_err={err:.3e}; fused q/k/v views: fp32 "
          f"max_abs_err={views[0][1]:.3e}, bf16 (mma) max_err={views[1][1]:.3f}; bf16 on the "
          f"scalar route (D=96 x 3 masks, an unaligned q): max_err "
          f"{max(e for _, e in scalar_bf16):.3f} of (1 bf16 ulp + tol)")
    require(ok and all(o for o, _ in views + scalar_bf16),
            f"{name} disagrees with its plain version on layouts or views")
    worst[torch.float32] = max(worst[torch.float32], err, views[0][1])
    worst[torch.bfloat16] = max([worst[torch.bfloat16], views[1][1]] + [e for _, e in scalar_bf16])
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
    """At both prefill shapes and Gemma-2B's training shape in bf16, causal:
    the work is the unmasked (query, key) pairs, 4 * D flops each on the
    tensor cores' rate. The tensor-core route (the one ``flash_attention``
    takes here) and the scalar route (through the module's private
    launcher) in turns: scalar, tensor cores, tensor cores, scalar; each
    route's time is the mean of its two medians."""
    from repro_torch.kernels.flash_attention import _launch, flash_attention, flash_attention_ref

    sdpa = torch.nn.functional.scaled_dot_product_attention
    flush = flush_buffer()
    rows = {}
    for tag, (B, S, H, K, D) in FLASH_SHAPES.items():
        q, k, v = flash_inputs(B, S, S, H, K, D, torch.bfloat16, 7)
        qt, kt, vt = (t.transpose(1, 2) for t in (q, k, v))
        pairs = B * H * S * (S + 1) // 2
        flops = 4 * D * pairs
        flash_routed(q, k, v, "mma")
        routes = {"scalar": lambda: _launch(q, k, v, True, 0, False, "scalar"),
                  "mma": lambda: flash_attention(q, k, v)}
        turns = [(name, time_ms(routes[name], flush))
                 for name in ("scalar", "mma", "mma", "scalar")]
        tc_ms = float(np.mean([t for name, t in turns if name == "mma"]))
        scalar_ms = float(np.mean([t for name, t in turns if name == "scalar"]))
        rows[tag] = lm_row(
            f"flash_attention {tag}: B={B} S={S} H/K={H}/{K} D={D} bf16 causal, tensor-core route",
            None, lambda: flash_attention_ref(q, k, v),
            lambda: sdpa(qt, kt, vt, is_causal=True, enable_gqa=True),
            (2 * B * S * H * D + 2 * B * S * K * D) * 2, flops, flush,
            tensor_core=True, kernel_ms=tc_ms)
        rows[tag].update(B=B, S=S, H=H, K=K, D=D, dtype="bfloat16", causal=True, route="mma",
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
    del flush
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


# ---------------------------------------------------------------------------
# phases 3-4 for the training path: fused_cross_entropy, the flash kernel's
# lse, and the grad guard of every kernel
# ---------------------------------------------------------------------------

def ce_inputs(T, d, V, dtype, layout, seed, same_label=False):
    """hidden ~ N(0, 1), a head ~ N(0, 1/d) so logits are O(1), labels with
    0 and V - 1 among them (or one label for every token). ``layout`` is
    "tied" (the transposed view of a (V, d) table), "contiguous" (a (d, V)
    tensor) or "sliced" (the first V columns of a (d, V') tensor, V' a
    multiple of 8 above V: a (d, V) view with contiguous rows that the
    tensor-core route takes at any V)."""
    g = torch.Generator(device="cuda").manual_seed(seed)
    hidden = torch.randn((T, d), generator=g, device="cuda").to(dtype)
    if layout == "tied":
        head = (torch.randn((V, d), generator=g, device="cuda") / math.sqrt(d)).to(dtype).T
    else:
        pitch = V if layout == "contiguous" else -(-V // 8) * 8 + 8
        head = (torch.randn((d, pitch), generator=g, device="cuda") / math.sqrt(d)).to(dtype)
        head = head[:, :V]
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
            if main or not ok or c["T"] == 4096 and c["V"] == 256_000 or c.get("same_label"):
                print(f"  T={c['T']:4d} d={c['d']:4d} V={c['V']:6d} {str(c['dtype'])[6:]:8s} "
                      f"{c['layout']:10s} {route:6s}"
                      f"{' one label' if c.get('same_label') else ''}: max_abs_err={err:.3e} "
                      f"(tol {tol:.2e}){' [the training shape]' if main else ''}"
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
            if c.get("main") or share > 1.0 or (T, V) == (37, 1):
                print(f"  T={T:4d} d={c['d']:4d} V={V:6d} {str(dtype)[6:]:8s} "
                      f"{c['layout']:6s} {route:6s}: max error {share:.3f} of the allowance"
                      f"{' [the training chunk]' if c.get('main') else ''}"
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
    cases = [(B, S, H, K, D, dtype, mask)
             for dtype in (torch.float32, torch.bfloat16) for mask in ("causal", "window", "full")
             for (B, S, H, K, D) in ((1, 37, 4, 2, 64), (2, 300, 8, 1, 256), (1, 2047, 32, 8, 128),
                                     FLASH_SHAPES["gemma-2b train"])]
    for i, (B, S, H, K, D, dtype, mask) in enumerate(cases):
        q, k, v = flash_inputs(B, S, S, H, K, D, dtype, 100 + i)
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
            raise AssertionError(f"flash_attention lse disagrees: {(B, S, H, K, D, dtype, mask)}"
                                 f" rel {err:.3e}")
    print(f"kernels: flash_attention lse ok ({len(cases)} cases, bf16 on the tensor-core "
          f"route, fp32 on the scalar one; max error {worst:.3e} of max(1, |lse|), tol 1e-5; "
          f"the output equals the call without lse)")
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
    from repro_torch.kernels.ssm_scan import ssm_scan

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
    turns = [(name, time_ms(routes[name], flush, iters=5, warmup=1))
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
    del flush
    return {"gemma-2b train": r}, {"gemma-2b train chunk": probs}


# ---------------------------------------------------------------------------
# phases 14-17: serving the LM substrate
# ---------------------------------------------------------------------------

def prompt_tokens(vocab, B, S, seed=0):
    r = np.random.default_rng(seed)
    return torch.from_numpy(r.integers(0, vocab, (B, S)).astype(np.int32)).cuda()


def serving_lane(label, model, params):
    """One request as a user sends it: prefill of B = 4 prompts of 2048
    tokens, then greedy decode to 32 tokens (31 decode steps), through
    ``repro_torch.launch.serve.generate``, after one short warm-up request.
    Every launch count is set to 0 just before and read just after."""
    from repro_torch.kernels.ssm_scan import launch_plan
    from repro_torch.launch.serve import generate

    cfg = model.cfg
    prompt = prompt_tokens(cfg.vocab_size, SERVE_BATCH, PROMPT)
    generate(model, params, prompt[:, :64], 3)
    torch.cuda.synchronize()
    torch.cuda.reset_peak_memory_stats()
    held = torch.cuda.memory_allocated()
    reset_counts()
    ids, prefill_s, decode_s = generate(model, params, prompt, SERVE_TOKENS)
    counts, tc = launch_counts(), flash_tc_launches()
    lanes = dict(counters()["ssm_scan"].lane_launches)
    peak = torch.cuda.max_memory_allocated()
    n_attn = sum(s.mixer == "attn" for s in model.plan)
    n_mamba = len(model.plan) - n_attn
    want = {k: 0 for k in KERNELS}
    want.update(flash_attention=n_attn, ssm_scan=n_mamba * SERVE_TOKENS)
    require(counts == want, f"{label}: launches {counts}, want {want}")
    require(tc == n_attn, f"{label}: {tc} of {n_attn} flash launches took the tensor-core route")
    want_lanes = dict.fromkeys(lanes, 0)
    want_lanes[launch_plan(PROMPT)] += n_mamba
    want_lanes[launch_plan(1)] += n_mamba * (SERVE_TOKENS - 1)
    require(lanes == want_lanes, f"{label}: ssm_scan launches by lanes a channel {lanes}, "
            f"want the launch plan's {want_lanes}")
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
    if cfg.moe is None:
        return cfg
    return dataclasses.replace(cfg, moe=dataclasses.replace(cfg.moe, capacity_factor=8.0))


def lm_invariant(label, model, params):
    """The reference's own invariant (tests/test_arch_smoke.py) at full width
    in bf16: prefill of S - 1 tokens, then one decode step, gives the logits
    that a forward over S tokens gives at the last position; MoE at capacity
    factor 8, so nothing drops. The two paths round to bf16 at other places
    (other matmul shapes, the flash kernel against decode_attention), so the
    logits are held to INVARIANT_RTOL of their largest magnitude."""
    from repro_torch.models.transformer import TransformerLM

    m = TransformerLM(no_drop(model.cfg), device="cuda")
    B, S = INVARIANT_SHAPE
    tokens = prompt_tokens(m.cfg.vocab_size, B, S, seed=1)
    hidden, _, _ = m.forward(params, {"tokens": tokens}, mode="train")
    full = (hidden[:, -1:] @ m._head(params)).float()
    caches, _ = m.prefill(params, {"tokens": tokens[:, :-1]}, cache_len=S)
    logits, _ = m.decode_step(params, {"tokens": tokens[:, -1:], "pos_offset": S - 1}, caches)
    require(bool(torch.isfinite(logits).all()) and logits.shape == full.shape,
            f"{label}: bad decode logits")
    err = float((logits - full).abs().max())
    scale = float(full.abs().max())
    agree = float((logits.argmax(-1) == full.argmax(-1)).float().mean())
    print(f"  {label}: B={B} S={S} bf16, max |decode - forward| {err:.4e} of max |logit| "
          f"{scale:.4f} ({err / scale:.3%}; tol {INVARIANT_RTOL:.3%}); argmax agree {agree:.2f}")
    require(err <= INVARIANT_RTOL * scale, f"{label}: prefill+decode != forward")
    return {"model": label, "batch": B, "seq": S, "max_abs_err": err, "max_abs_logit": scale}


def reduced_card_vs_cpu(arch):
    """The reduced config in fp32: prefill + 3 decode steps on the card
    against the CPU on the same params (the kernels against their plain
    versions, end to end), held to the reference's own consistency bound on
    the logits and to 1e-4 on every cache leaf."""
    from repro_torch.configs import get_config
    from repro_torch.configs.base import reduced
    from repro_torch.models.transformer import TransformerLM
    from repro_torch.utils.tree import tree_leaves, tree_map

    cfg = reduced(get_config(arch))
    gpu, cpu = TransformerLM(cfg, device="cuda"), TransformerLM(cfg, device="cpu")
    params = gpu.init(0)
    params_cpu = tree_map(lambda t: t.cpu(), params)
    tokens = prompt_tokens(cfg.vocab_size, 2, 40, seed=2).cpu()
    c_gpu, l_gpu = gpu.prefill(params, {"tokens": tokens.cuda()}, cache_len=44)
    c_cpu, l_cpu = cpu.prefill(params_cpu, {"tokens": tokens}, cache_len=44)
    logit_err = cache_err = 0.0
    for step in range(4):
        logit_err = max(logit_err, float((l_gpu.cpu() - l_cpu).abs().max()))
        cache_err = max(cache_err, max(float((a.cpu().double() - b.double()).abs().max())
                                       for a, b in zip(tree_leaves(c_gpu), tree_leaves(c_cpu))))
        if step == 3:
            break
        tok = torch.argmax(l_cpu[:, -1], dim=-1)[:, None]
        l_gpu, c_gpu = gpu.decode_step(params, {"tokens": tok.cuda(), "pos_offset": 40 + step},
                                       c_gpu)
        l_cpu, c_cpu = cpu.decode_step(params_cpu, {"tokens": tok, "pos_offset": 40 + step},
                                       c_cpu)
    print(f"  reduced {arch} fp32, prefill 2x40 + 3 decode steps: card vs CPU logits "
          f"max_abs_err {logit_err:.3e} (tol {REDUCED_LOGITS_ATOL}), cache leaves "
          f"{cache_err:.3e} (tol {REDUCED_CACHE_ATOL})")
    require(logit_err <= REDUCED_LOGITS_ATOL and cache_err <= REDUCED_CACHE_ATOL,
            f"reduced {arch}: card and CPU disagree")
    return {"arch": arch, "logits_err": logit_err, "cache_err": cache_err}


def profile_serving(label, model, params):
    """One prefill (B = 4, 2048 tokens) and one decode step under
    torch.profiler: device busy (the union of the ops' intervals) against
    the host wall, the top ops, and the two kernels' share."""
    cfg = model.cfg
    prompt = prompt_tokens(cfg.vocab_size, SERVE_BATCH, PROMPT)
    box = {}

    def prefill():
        box["caches"], box["logits"] = model.prefill(params, {"tokens": prompt},
                                                     cache_len=PROMPT + SERVE_TOKENS)

    def decode():
        tok = torch.argmax(box["logits"][:, -1], dim=-1)[:, None]
        model.decode_step(params, {"tokens": tok, "pos_offset": PROMPT}, box["caches"])

    out = {}
    for what, fn in (("prefill", prefill), ("decode step", decode)):
        wall, ops, rows = device_profile(fn)
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
        out[what] = {"wall_s": wall, "device_busy_s": busy, "idle_share": 1 - busy / wall,
                     "device_ops": len(ops), "kernels": shares}
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
                 "flash_attention": steps * 18 * 2, "fedavg_aggregate": n_leaves}
    out = {}
    for algo, argv, per in (
            ("fedavg", TRAIN_ARGV, per_round),
            ("fedsgd", TRAIN_ARGV + ["--algo", "fedsgd"],
             {"fused_cross_entropy": 1, "ce_probs": CE_CHUNKS, "flash_attention": 36,
              "fedavg_aggregate": 0})):
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
    batches: the kernels' forwards, the CE gradient's ce_probs (all on their
    scalar routes, required) and the plain attention backward against the
    plain versions end to end. Twice: with SGD, whose update is linear in the
    gradients, the loss and the update (the whole tree's, in L2, and each
    attention weight's and the tied head's) within TRAIN_RTOL; with AdamW,
    the local optimizer of the main path, the loss and the groups' moments
    mu and nu (linear and quadratic in the gradients; the trees and the same
    leaves) within TRAIN_RTOL. The AdamW update itself is not compared: its
    first steps are lr * g / |g|, so a gradient element at rounding level
    steps by +-lr on either side."""
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
    start = TransformerLM(cfg, device="cuda").init(0)
    n_attn = sum(s.mixer == "attn" for s in TransformerLM(cfg, device="cuda").plan)
    paths = ["/".join(map(str, p)) for p in tree_paths(start)]
    steps = TRAIN_G * TRAIN_H
    step_tokens = shape[2] * shape[3]
    chunks = -(-step_tokens // (shape[2] * cfg.ce_chunk)) if cfg.ce_chunk else 1

    def rel_l2(got, want):
        num = math.sqrt(sum(float(((a - b) ** 2).sum()) for a, b in zip(got, want)))
        return num / math.sqrt(sum(float((b ** 2).sum()) for b in want))

    out = {"arch": arch}
    for name, make in (("SGD", lambda: sgd(0.05)), ("AdamW", lambda: adamw(1e-3))):
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
                    flash_attention=steps * n_attn, fedavg_aggregate=len(u_gpu))
        require(n_gpu == want, f"reduced {arch} {name} round: launches {n_gpu}, want {want}")
        require(tc == (0, 0, 0), f"reduced {arch} {name} round: fp32 took a tensor-core "
                f"route (flash, CE, ce_probs: {tc})")
        l_err = abs(l_gpu - l_cpu) / abs(l_cpu)
        n = len(paths)
        # (what, rel L2 of the tree, per-leaf (got, want) of the attention weights and head)
        if name == "SGD":
            checks = [("update", u_gpu, u_cpu)]
        else:
            checks = [("mu", m_gpu[:n], m_cpu[:n]), ("nu", m_gpu[n:], m_cpu[n:])]
        tree_err = {k: rel_l2(g, w) for k, g, w in checks}
        leaf_err = {f"{k} {p}": float((a - b).norm() / b.norm())
                    for k, g, w in checks for p, a, b in zip(paths, g, w)
                    if p.split("/")[-1] in ("wq", "wk", "wv", "wo", "table")}
        worst_key = max(leaf_err, key=leaf_err.get)
        worst_leaf = leaf_err[worst_key]
        print(f"  reduced {arch} fp32, one round G={TRAIN_G} H={TRAIN_H} {name}: loss "
              f"{l_gpu:.6f} vs CPU {l_cpu:.6f} (rel {l_err:.2e}); "
              + ", ".join(f"{k} rel L2 {e:.2e}" for k, e in tree_err.items())
              + f"; attention weights and tied head, worst {worst_leaf:.2e} ({worst_key}) "
              f"(tol {TRAIN_RTOL:g}); launches {({k: v for k, v in n_gpu.items() if v})}")
        require(max([l_err, worst_leaf, *tree_err.values()]) <= TRAIN_RTOL,
                f"reduced {arch} {name}: the card's round and the CPU's disagree")
        out[name] = {"loss_rel_err": l_err, **{f"{k}_rel_err": e for k, e in tree_err.items()},
                     "attention_and_head_worst_rel_err": worst_leaf}
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
    ranges = ("flash_attention_bwd", "fused_cross_entropy_bwd")
    # the device copies of the two ranges (user annotations) span their
    # kernels and the gaps between them: they are not kernels
    kernels = [e for e in events if e.device_type == DeviceType.CUDA and e.name not in ranges
               and not getattr(e, "is_user_annotation", False)]
    busy = busy_seconds((e.time_range.start, e.time_range.end) for e in kernels)
    by_name = {}
    for e in kernels:
        us, count = by_name.get(e.name, (0.0, 0))
        by_name[e.name] = (us + e.time_range.elapsed_us(), count + 1)
    rows = sorted(((us, c, k) for k, (us, c) in by_name.items()), reverse=True)

    raw = prof.profiler.kineto_results.events()
    on_device = [e for e in raw if e.device_type() == DeviceType.CUDA
                 and not e.is_user_annotation()]
    launch_of = {}
    for e in raw:
        if e.device_type() == DeviceType.CPU and "aunch" in e.name() and e.correlation_id():
            launch_of[e.correlation_id()] = e.start_ns()

    def range_ms(name):
        """Device time of a host range: on the one stream, every kernel
        from the first to the last of those whose launch call (matched by
        correlation id) falls inside one of the range's host spans. The
        profiler's op tree alone misses kernels that no torch op launches
        (ctypes launches, cuBLASLt's cuLaunchKernelEx launches)."""
        spans = [(e.start_ns(), e.end_ns()) for e in raw
                 if e.device_type() == DeviceType.CPU and e.name() == name]
        total = 0
        for a, b in spans:
            mine = [k for k in on_device
                    if a <= launch_of.get(k.correlation_id(), -1) <= b]
            if mine:
                lo = min(k.start_ns() for k in mine)
                hi = max(k.end_ns() for k in mine)
                total += sum(k.duration_ns() for k in on_device if lo <= k.start_ns() < hi)
        return total / 1e6, len(spans)

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
        **{f"{name} (range)": range_ms(name) for name in ranges},
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
# phases 5-9: the main paths
# ---------------------------------------------------------------------------

def host_vector(tree) -> torch.Tensor:
    from repro_torch.utils.tree import tree_map, tree_ravel

    return tree_ravel(tree_map(lambda p: p.detach().cpu().double(), tree))[0]


def make_engine(model_name, data, codec=None, spec_name=None, topology=None):
    """``RoundEngine`` on the card for ``model_name`` at full size, with the
    fedavg and partition sections of ``specs/<spec_name>.json`` (read as
    JSON; by default the model's own non-IID cell ``<model>_noniid``);
    returns the engine, the model and its config."""
    from repro_torch.core.engine import RoundEngine
    from repro_torch.core.fedavg import FedAvgConfig
    from repro_torch.core.simulation import make_eval_fn
    from repro_torch.data.partition import partition_pathological_noniid
    from repro_torch.models import paper
    from repro_torch.utils.tree import tree_leaves

    spec = json.loads((ROOT / "specs" / f"{spec_name or model_name + '_noniid'}.json").read_text())
    fed, part = spec["fedavg"], spec["partition"]
    require(part["kind"] == "pathological_noniid", f"unexpected spec {spec['name']}")
    train, test = data
    split = partition_pathological_noniid(
        train.y, part["n_clients"], part["shards_per_client"], seed=part["seed"])
    clients = [(train.x[i], train.y[i]) for i in split.client_indices]
    cfg = FedAvgConfig(C=fed["C"], E=fed["E"], B=fed["B"], lr=fed["lr"],
                       lr_decay=fed["lr_decay"], seed=fed["seed"])
    model = getattr(paper, model_name)(device="cuda")
    params = model.init(fed["seed"])
    n_params = sum(p.numel() for p in tree_leaves(params))
    require(n_params == MAIN_N[model_name], f"{model_name} has {n_params} params")
    eng = RoundEngine(model.loss, params, clients, cfg,
                      eval_fn=make_eval_fn(model.apply, test.x, test.y, device="cuda"),
                      codec=codec, topology=topology, device="cuda")
    print(f"  {spec['name']}" + ("" if spec["model"]["kind"] == model_name else
                                 f" (its sections, with {model_name})")
          + f": {len(clients)} clients x {int(split.client_sizes[0])} examples, "
          f"C={cfg.C} E={cfg.E} B={cfg.B} lr={cfg.lr}, {n_params} params, "
          f"{eng.packed.max_real_steps_per_epoch * cfg.E} steps/round"
          + (f", codec {codec.name}" if codec is not None else "")
          + (f", topology {topology.name}" if topology is not None else ""))
    return eng, model, cfg


def run_lane(name, eng, n_rounds, kernel):
    """One lane's main path: every launch count set to 0, ``RoundEngine.run``,
    the counts read. ``kernel`` must have launched once a round and every
    other kernel never (``None``: no hand kernel at all)."""
    torch.cuda.reset_peak_memory_stats()
    reset_counts()
    hist = eng.run(n_rounds, eval_every=1)
    torch.cuda.synchronize()
    counts = launch_counts()
    for r in hist.records:
        cons = "" if r.consensus is None else f"consensus {r.consensus:.6f} "
        print(f"  round {r.round}: loss {r.train_loss:.6f} {cons}test_acc {r.test_acc:.4f} "
              f"test_loss {r.test_loss:.6f} wall_s {r.wall_s:.4f}")
    if eng.topology is not None and not all(
            math.isfinite(r.consensus) and r.consensus >= 0 for r in hist.records):
        raise AssertionError(f"{name}: bad consensus distances")
    losses = [r.train_loss for r in hist.records]
    if len(hist.records) != n_rounds or not all(math.isfinite(v) for v in losses):
        raise AssertionError(f"{name}: non-finite or missing round losses {losses}")
    accs = [r.test_acc for r in hist.records]
    if not all(math.isfinite(a) and 0.0 <= a <= 1.0 for a in accs):
        raise AssertionError(f"{name}: bad test accuracies {accs}")
    want = {k: (n_rounds if k == kernel else 0) for k in KERNELS}
    if counts != want:
        raise AssertionError(f"{name}: launches {counts} in {n_rounds} rounds, want {want}")
    require_main_route(name, kernel)
    print(f"  launches in the run ({n_rounds} rounds): "
          + ", ".join(f"{k} {v}" for k, v in counts.items())
          + f"; peak device memory {torch.cuda.max_memory_allocated() / 2**20:.0f} MiB")
    return (counts[kernel] if kernel else 0), [r.wall_s for r in hist.records]


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
    from repro_torch.core.engine import RoundBatch, RoundState, build_simulation_round_step
    from repro_torch.core.fedavg import sample_clients
    from repro_torch.utils.tree import tree_map

    eng, model, cfg = make_engine(model_name, data)

    # A round on the card against the same round on the CPU: same params,
    # same injected batches, short E=1 rounds of 1 and of CHECK_STEPS steps.
    ids = sample_clients(np.random.default_rng(1234), eng.num_clients, cfg.C)
    batch, mask, w = eng.materialize_round_batch(ids, generator_seed=1234)
    step = build_simulation_round_step(model.loss)
    start = host_vector(eng.params)
    for n_steps, rtol in ((1, UPDATE_RTOL_1), (CHECK_STEPS, UPDATE_RTOL_N)):
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

    launches, walls = run_lane(model_name, eng, ROUNDS[model_name], "fedavg_aggregate")
    return launches, walls, eng


def codec_from_spec(c):
    """The port's codec for a spec's ``codec`` section (the port has no spec
    loader yet)."""
    from repro_torch.core import compression as comp

    if c["kind"] == "quantize":
        return comp.quantize_codec(c["bits"], chunk=c["chunk"])
    if c["kind"] == "topk":
        return comp.topk_codec(c["keep_frac"])
    if c["kind"] == "lowrank":
        return comp.lowrank_codec(c["rank"])
    raise ValueError(f"no codec for {c['kind']!r}")


def recording(codec, box):
    """``codec`` with its encode and aggregate wrapped to keep the last
    round's payloads, weights and card aggregate in ``box``; the codec's
    own functions do the work."""
    def encode(seed, flat):
        box["payloads"] = codec.encode(seed, flat)
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

    codec = codec_from_spec(dict(
        json.loads((ROOT / "specs" / f"{spec_name}.json").read_text())["codec"], **override))
    print(f"  codec {codec.name} from specs/{spec_name}.json"
          + (f" with {override}" if override else "")
          + f"; aggregate through {kernel or 'an einsum (no hand kernel)'}")
    box = {}
    eng, _, _ = make_engine(model_name, data, codec=recording(codec, box))
    launches, walls = run_lane(f"{model_name} {codec.name}", eng, COMPRESSED_ROUNDS, kernel)

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


def device_profile(fn):
    """Run ``fn`` once under torch.profiler's CUDA activity (CUPTI): its host
    wall time, which ends when the card has finished, the device ops, and
    (self device µs, count, name) rows by kernel, longest first."""
    from torch.autograd import DeviceType
    from torch.profiler import ProfilerActivity, profile

    torch.cuda.synchronize()
    with profile(activities=[ProfilerActivity.CUDA]) as prof:
        t0 = time.perf_counter()
        fn()
        torch.cuda.synchronize()
        wall = time.perf_counter() - t0
    ops = [e for e in prof.events() if e.device_type == DeviceType.CUDA]
    rows = []
    for e in prof.key_averages():
        us = getattr(e, "self_device_time_total", None)
        if us is None:
            us = e.self_cuda_time_total
        if us > 0:
            rows.append((us, e.count, e.key))
    rows.sort(reverse=True)
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


def spec_topology(spec_name):
    """The ``Topology`` of a spec's ``topology`` section, its ``None``
    fields dropped as the reference's ``TopologySpec.build`` drops them."""
    from repro_torch.core.topology import topology_from_json

    t = json.loads((ROOT / "specs" / f"{spec_name}.json").read_text())["topology"]
    return topology_from_json({k: v for k, v in t.items() if v is not None})


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
    topo = spec_topology(spec_name)
    eng, model, cfg = make_engine(model_name, data, spec_name=spec_name, topology=topo)
    require(eng.num_clients == N_NODES and eng.plan.n_nodes == N_NODES,
            f"{spec_name}: {eng.num_clients} nodes")
    print(f"  plan: {eng.plan.n_nodes} nodes x {eng.plan.max_slots} slots, "
          f"{int(np.count_nonzero(eng.plan.weight))} non-zero")
    # the CPU takes seconds a step for 100 CNN nodes: one step there
    steps = ((1, GOSSIP_CNN_RTOL_1),) if model_name == "mnist_cnn" else \
        ((1, UPDATE_RTOL_1), (CHECK_STEPS, UPDATE_RTOL_N))
    gossip_card_vs_cpu(f"{model_name} {topo.kind}", eng, model, cfg, steps)
    launches, walls = run_lane(f"{model_name} {topo.kind}", eng, GOSSIP_ROUNDS, "gossip_mix")
    from repro_torch.kernels.gossip_mix import _route

    route = _route(torch.empty((eng.plan.n_nodes, 1), device="meta"), eng._mix_idx,
                   eng._mix_w)
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


def print_ptxas(log):
    """One line per compiled kernel: registers and spill stores."""
    entry, spill = "?", "?"
    for line in log.splitlines():
        if "Compiling entry function" in line:
            mangled = line.split("'")[1]
            for base in ("qagg_stream_kernel", "packed_qagg_kernel", "qagg_kernel",
                         "fedavg_agg_kernel", "sparse_agg_fused_kernel",
                         "sparse_agg_kernel", "gossip_mix_dense_kernel", "gossip_mix_kernel",
                         "flash_fwd_mma_kernel", "flash_fwd_kernel", "ssm_scan_ring_kernel",
                         "ssm_scan_kernel", "ce_fwd_mma_kernel",
                         "ce_probs_mma_kernel", "ce_probs_kernel", "ce_partial_kernel",
                         "ce_merge_kernel"):
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
    }
    flash_lse_err = check_flash_lse()
    check_grad_guard()

    phase("4. timing (CUDA events, median of 200, L2 flushed to clean lines before each "
          "launch)")
    print(f"card: {smi}")
    timing = {"fedavg_aggregate": {**time_fedavg_aggregate(),
                                   "gemma-2b train leaves": time_fedavg_training_leaves()},
              **time_wire_kernels(),
              "gossip_mix": time_gossip_mix(), "flash_attention": time_flash_attention(),
              "ssm_scan": time_ssm_scan()}
    timing["fused_cross_entropy"], timing["ce_probs"] = time_fused_cross_entropy()

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

    phase("10. plain and q8 CNN rounds in turns (plain, q8, q8, plain), host clock to the synced loss")
    turns = []
    reset_counts()
    for name, eng in (("plain", eng_cnn), ("q8", eng_cnn_q8), ("q8", eng_cnn_q8),
                      ("plain", eng_cnn)):
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        float(eng.round()["loss"])
        turns.append((name, time.perf_counter() - t0))
        print(f"  {name:5s} round {turns[-1][1]:.4f} s")
    require(launch_counts()["quantized_aggregate"] == 2, "two q8 rounds, two launches")
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
    card_vs_cpu = [reduced_card_vs_cpu("jamba-v0.1-52b"), reduced_card_vs_cpu("gemma-2b")]

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
    train_checks = {"reduced_card_vs_cpu": [reduced_round_card_vs_cpu("gemma-2b"),
                                            reduced_round_card_vs_cpu("qwen2-72b")]}
    free_card()
    train_checks["full_width"] = full_width_ce_checks()
    free_card()

    phase("20. where the time goes training: one group step of Gemma-2B under torch.profiler")
    train_profile = profile_training_step()
    free_card()

    phase("summary")
    launches = {"fedavg_aggregate": launches_2nn + launches_cnn}
    for k in WIRE_KERNELS:
        launches[k] = sum(lane["launches"] for lane in lanes if lane["kernel"] == k)
    launches["gossip_mix"] = sum(lane["launches"] for lane in gossip)
    for k in ("flash_attention", "ssm_scan"):
        launches[k] = sum(lane["launches"][k] for lane in serving)
    for k in ("fedavg_aggregate", "flash_attention", "fused_cross_entropy", "ce_probs"):
        launches[k] = launches.get(k, 0) + sum(run["launches"][k] for run in training.values())
    flash_tc = (sum(lane["flash_tc_launches"] for lane in serving)
                + sum(run["flash_tc_launches"] for run in training.values()))
    ce_tc = sum(run["ce_tc_launches"] for run in training.values())
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
    }
    main_shape = {k: "mnist_cnn" for k in KERNELS}
    main_shape.update(gossip_mix="ring/mnist_cnn", flash_attention="jamba",
                      ssm_scan="jamba/prefill", fused_cross_entropy="gemma-2b train",
                      ce_probs="gemma-2b train chunk")
    lanes_of = {"flash_attention": serving, "ssm_scan": serving,
                "fused_cross_entropy": [],   # their lane is kernels[7]["training"]
                "ce_probs": []}
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
    kernels[1]["cnn_rounds_in_turns_s"] = turns
    kernels[4]["anchor"] = anchor_res
    kernels[4]["cnn_ring_round_profile"] = gossip_profile
    for i in (1, 2):
        kernels[i]["routes"] = {
            "stream": "qagg_stream_kernel (uint8/uint16 codes, words at bits 1/2/4; chunk a "
                      "whole number of 16-byte granules, >= 64 bytes; aligned; K <= 32)",
            "general": "qagg_kernel / packed_qagg_kernel (the rest)"}
        stream = sum(lane["main_route_launches"] for lane in lanes
                     if lane["kernel"] == KERNELS[i])
        kernels[i]["route_launches"] = {"stream": stream,
                                        "general": launches[KERNELS[i]] - stream}
    kernels[3]["routes"] = {
        "fused": "sparse_agg_fused_kernel (k % 4 == 0; idx, fp32 vals and out 16-byte "
                 "aligned, bf16 vals 8-byte aligned): one cooperative launch zeroes and "
                 "scatters",
        "scatter": "a fill, then sparse_agg_kernel (the rest)"}
    fused = sum(lane["main_route_launches"] for lane in lanes if lane["kernel"] == KERNELS[3])
    kernels[3]["route_launches"] = {"fused": fused, "scatter": launches[KERNELS[3]] - fused}
    kernels[4]["routes"] = {
        "gather": "gossip_mix_kernel (D * DENSE_NODES_PER_SLOT < n: the ring, the small world)",
        "dense": "gossip_mix_dense_kernel (the rest: the full graph)"}
    dense = sum(lane["dense_launches"] for lane in gossip)
    kernels[4]["route_launches"] = {"gather": launches["gossip_mix"] - dense, "dense": dense,
                                    "dense in the anchor (phase 12)": 1}
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
    kernels[5]["tc_launches"] = flash_tc
    kernels[5]["routes"] = {"mma": "flash_fwd_mma_kernel (bf16, D 64/128/256, aligned rows)",
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
    print(f"\nchip_smoke: all phases passed in {time.perf_counter() - t_start:.1f} s")
    print(smi)
    print(json.dumps({"kernels": kernels}))
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": kind, "count": torch.cuda.device_count()}}))
    return 0


if __name__ == "__main__":
    sys.exit(main())
