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
   call as a yardstick, and the bound (CUDA events, L2 flushed);
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
    are compared on one card at one time.

Every kernel's launch count is set to 0 just before each lane's run and
read just after. The last three lines are the card's ``nvidia-smi`` name and
power limit, a ``{"kernels": [...]}`` record and ``{"ok": true, "device":
{...}}``. Any failure exits non-zero before those lines; so does a machine
without a card.
"""
from __future__ import annotations

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
L2_FLUSH_BYTES = 256 * 2**20            # well above the 50 MB L2
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

KERNELS = ("fedavg_aggregate", "quantized_aggregate", "packed_quantized_aggregate",
           "sparse_aggregate")
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


def require(cond: bool, msg: str) -> None:
    if not cond:
        raise AssertionError(msg)


def phase(title: str) -> None:
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
    from repro_torch.kernels.sparse_agg import sparse_aggregate

    return {f.__name__: f for f in (fedavg_aggregate, quantized_aggregate,
                                    packed_quantized_aggregate, sparse_aggregate)}


def launch_counts():
    return {name: f.launches for name, f in counters().items()}


def reset_counts():
    for f in counters().values():
        f.launches = 0


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


def check_quantized_aggregate():
    from repro_torch.kernels.quantized_agg import (
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
    before = quantized_aggregate.launches
    main_err = worst = 0.0
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
        out = quantized_aggregate(codes, lo, scale, w, chunk=chunk, levels=levels)
        ref = quantized_aggregate_ref(codes, lo, scale, w, chunk=chunk, levels=levels)
        dense = dequantize_ref(codes[: K - ghosts], lo[: K - ghosts], scale[: K - ghosts],
                               chunk=chunk, levels=levels)
        tag = (f"K={K:2d} N={c['N']:8d} chunk={chunk:3d} {str(c['dtype'])[6:]:6s} "
               f"vec={access_width(codes, out, chunk):2d}"
               + (" ghosts" if ghosts else "") + (" misaligned" if c.get("misaligned") else ""))
        err = sum_check(name, tag, out, ref, float(dense.abs().max()))
        worst = max(worst, err)
        if K == MAIN_K and c["N"] in MAIN_N.values() and c["dtype"] == torch.uint8 and not ghosts:
            main_err = max(main_err, err)
    require(quantized_aggregate.launches - before == len(cases), "one launch per case")
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
    print(f"kernels: {name} cuda ok ({len(cases)} cases, max_abs_err {worst:.3e} within "
          f"1e-6*max|term|; {n_ref} refusals)")
    return main_err


def check_packed_quantized_aggregate():
    from repro_torch.kernels.quantized_agg import (
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
              for N in MAIN_N.values() for bits in (1, 3, 4, 12)]
    cases += [dict(K=K, N=1000, chunk=CHUNK, bits=4, ghosts=max(1, K // 4)) for K in (2, 10, 17)]
    before = packed_quantized_aggregate.launches
    main_err = worst = 0.0
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
        out = packed_quantized_aggregate(words, lo, scale, w, **kw)
        ref = packed_quantized_aggregate_ref(words, lo, scale, w, **kw)
        real = K - ghosts
        dense = dequantize_ref(unpack_ref(words[:real], bits=bits, chunk=chunk),
                               lo[:real], scale[:real], chunk=chunk, levels=2**bits - 1)
        tag = (f"bits={bits:2d} K={K:2d} N={c['N']:8d} chunk={chunk:3d}"
               + (" ghosts" if ghosts else ""))
        err = sum_check(name, tag, out, ref, float(dense.abs().max()))
        worst = max(worst, err)
        if K == MAIN_K and c["N"] in MAIN_N.values() and bits == 4:
            main_err = max(main_err, err)
    require(packed_quantized_aggregate.launches - before == len(cases), "one launch per case")
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
    print(f"kernels: {name} cuda ok ({len(cases)} cases, bits 1..15, max_abs_err "
          f"{worst:.3e} within 1e-6*max|term|; {n_ref} refusals)")
    return main_err


def sparse_case(K, n, k, dtype, seed, *, unique=True, ghosts=0, out_of_range=False):
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
    return idx.contiguous(), vals.to(dtype).contiguous(), normalized(K, ghosts, seed)


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
    before = sparse_aggregate.launches
    main_err = worst = 0.0
    for i, c in enumerate(cases):
        K, n, ghosts = c["K"], c["n"], c.get("ghosts", 0)
        k = max(n * 5 // 100, 1)
        idx, vals, w = sparse_case(K, n, k, c["dtype"], seed=i, unique=c.get("unique", True),
                                   ghosts=ghosts, out_of_range=c.get("out_of_range", False))
        out = sparse_aggregate(idx, vals, w, n)
        ref = sparse_aggregate_ref(idx, vals, w, n)
        tag = (f"K={K:2d} n={n:8d} k={k:6d} {str(c['dtype'])[6:]:8s}"
               + (" ghosts" if ghosts else "") + (" duplicates" if not c.get("unique", True) else "")
               + (" out-of-range dropped" if c.get("out_of_range") else ""))
        # atomics add in an order that varies from run to run: not bitwise
        err = sum_check(name, tag, out, ref, float(vals[: K - ghosts].float().abs().max()))
        worst = max(worst, err)
        if K == MAIN_K and n in MAIN_N.values() and c["dtype"] == torch.float32:
            main_err = max(main_err, err)
    require(sparse_aggregate.launches - before == len(cases), "one launch per case")
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
    print(f"kernels: {name} cuda ok ({len(cases)} cases, max_abs_err {worst:.3e} within "
          f"1e-6*max|term|; {n_ref} refusals)")
    return main_err


# ---------------------------------------------------------------------------
# phase 4: timing
# ---------------------------------------------------------------------------

def time_ms(fn, flush, iters=200, warmup=20):
    """Median device time of ``fn`` over ``iters`` launches, each after an
    L2 flush, between CUDA events."""
    for _ in range(warmup):
        fn()
    starts = [torch.cuda.Event(enable_timing=True) for _ in range(iters)]
    ends = [torch.cuda.Event(enable_timing=True) for _ in range(iters)]
    for s, e in zip(starts, ends):
        flush.zero_()
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

    flush = torch.empty(L2_FLUSH_BYTES // 4, device="cuda")
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


def bound_of(nbytes, fp32_ops, int_ops=0):
    """Least time on the card (ms) and what sets it: bytes over the HBM rate
    against operations over the peak rate of their type."""
    t_bytes = nbytes / HBM_BYTES_PER_S
    t_ops = fp32_ops / FP32_FLOPS + int_ops / INT32_OPS
    return max(t_bytes, t_ops) * 1e3, ("bytes" if t_bytes >= t_ops else "operations")


def timing_row(tag, fn, plain, library, nbytes, fp32_ops, flush, int_ops=0):
    bound, by = bound_of(nbytes, fp32_ops, int_ops)
    r = {"ms": time_ms(fn, flush), "plain_ms": time_ms(plain, flush),
         "library_ms": time_ms(library, flush), "bound_ms": bound, "bound_by": by,
         "bytes": nbytes}
    r["achieved_GBps"] = nbytes / (r["ms"] * 1e-3) / 1e9
    r["bound_share"] = bound / r["ms"]
    print(f"  {tag}: kernel_ms={r['ms']:.5f} bound_ms={bound:.5f} ({by}; "
          f"{r['bound_share']:.1%} of bound, {r['achieved_GBps']:.0f} GB/s) "
          f"plain_ms={r['plain_ms']:.5f} library_ms={r['library_ms']:.5f}")
    return r


def time_wire_kernels():
    """The three wire kernels at the main paths' shapes: K=10 clients, the
    2NN's and the CNN's N, chunk 512; q8 codes, q4 words, top-5% pairs."""
    from repro_torch.kernels.fedavg_agg import fedavg_aggregate
    from repro_torch.kernels.quantized_agg import (
        dequantize_ref,
        packed_quantized_aggregate,
        packed_quantized_aggregate_ref,
        quantized_aggregate,
        quantized_aggregate_ref,
        unpack_ref,
    )
    from repro_torch.kernels.sparse_agg import sparse_aggregate, sparse_aggregate_ref
    from repro_torch.utils.bitpack import words_per_chunk

    flush = torch.empty(L2_FLUSH_BYTES // 4, device="cuda")
    K = MAIN_K
    rows = {name: {} for name in KERNELS[1:]}
    for model, N in MAIN_N.items():
        C = -(-N // CHUNK)
        n_pad = C * CHUNK
        lo, scale = ranges(K, C, seed=7)
        w = normalized(K, seed=7)
        codes = random_codes(K, n_pad, torch.uint8, seed=7)
        kw = dict(chunk=CHUNK, levels=255)
        rows["quantized_aggregate"][model] = timing_row(
            f"quantized_aggregate q8 {model}: K={K} N_pad={n_pad} C={C}",
            lambda: quantized_aggregate(codes, lo, scale, w, **kw),
            lambda: quantized_aggregate_ref(codes, lo, scale, w, **kw),
            # yardstick: the composition the fusion removes
            lambda: fedavg_aggregate(dequantize_ref(codes, lo, scale, **kw), w),
            K * n_pad + 2 * K * C * 4 + n_pad * 4 + K * 4, 4 * K * n_pad, flush)

        wpc = words_per_chunk(CHUNK, 4)
        g = torch.Generator(device="cuda").manual_seed(7)
        words = torch.randint(-2**31, 2**31, (K, C * wpc), generator=g, dtype=torch.int32,
                              device="cuda")
        kw4 = dict(bits=4, chunk=CHUNK, levels=15)
        rows["packed_quantized_aggregate"][model] = timing_row(
            f"packed_quantized_aggregate q4 {model}: K={K} words={C * wpc} C={C}",
            lambda: packed_quantized_aggregate(words, lo, scale, w, **kw4),
            lambda: packed_quantized_aggregate_ref(words, lo, scale, w, **kw4),
            lambda: fedavg_aggregate(dequantize_ref(
                unpack_ref(words, bits=4, chunk=CHUNK), lo, scale, chunk=CHUNK, levels=15), w),
            K * C * wpc * 4 + 2 * K * C * 4 + n_pad * 4 + K * 4, 4 * K * n_pad, flush,
            int_ops=2 * K * n_pad)

        k = N * 5 // 100
        idx, vals, w2 = sparse_case(K, N, k, torch.float32, seed=7)
        flat_idx = idx.view(-1)

        def index_add():
            out = torch.zeros(N, device="cuda")
            return out.index_add_(0, flat_idx, (vals * w2[:, None]).view(-1))

        rows["sparse_aggregate"][model] = timing_row(
            f"sparse_aggregate top{TOPK:g} {model}: K={K} k={k} n={N}",
            lambda: sparse_aggregate(idx, vals, w2, N),
            lambda: sparse_aggregate_ref(idx, vals, w2, N),
            index_add,
            K * k * 8 + K * 4 + N * 4, 2 * K * k, flush)
    del flush
    return rows


# ---------------------------------------------------------------------------
# phases 5-9: the main paths
# ---------------------------------------------------------------------------

def host_vector(tree) -> torch.Tensor:
    from repro_torch.utils.tree import tree_map, tree_ravel

    return tree_ravel(tree_map(lambda p: p.detach().cpu().double(), tree))[0]


def make_engine(model_name, data, codec=None):
    """``RoundEngine`` on the card for the paper's non-IID cell of
    ``model_name`` (``specs/<model>_noniid.json``, read as JSON) at full
    size; returns the engine, the model and its config."""
    from repro_torch.core.engine import RoundEngine
    from repro_torch.core.fedavg import FedAvgConfig
    from repro_torch.core.simulation import make_eval_fn
    from repro_torch.data.partition import partition_pathological_noniid
    from repro_torch.models import paper
    from repro_torch.utils.tree import tree_leaves

    spec = json.loads((ROOT / "specs" / f"{model_name}_noniid.json").read_text())
    fed, part = spec["fedavg"], spec["partition"]
    require(spec["model"]["kind"] == model_name and part["kind"] == "pathological_noniid",
            f"unexpected spec {spec['name']}")
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
                      codec=codec, device="cuda")
    print(f"  {spec['name']}: {len(clients)} clients x {int(split.client_sizes[0])} examples, "
          f"C={cfg.C} E={cfg.E} B={cfg.B} lr={cfg.lr}, {n_params} params, "
          f"{eng.packed.max_real_steps_per_epoch * cfg.E} steps/round"
          + (f", codec {codec.name}" if codec is not None else ""))
    return eng, model, cfg


def run_lane(name, eng, n_rounds, kernel):
    """One lane's main path: every launch count set to 0, ``RoundEngine.run``,
    the counts read. ``kernel`` must have launched once a round and every
    other kernel never (``None``: no hand kernel at all)."""
    reset_counts()
    hist = eng.run(n_rounds, eval_every=1)
    torch.cuda.synchronize()
    counts = launch_counts()
    for r in hist.records:
        print(f"  round {r.round}: loss {r.train_loss:.6f} test_acc {r.test_acc:.4f} "
              f"test_loss {r.test_loss:.6f} wall_s {r.wall_s:.4f}")
    losses = [r.train_loss for r in hist.records]
    if len(hist.records) != n_rounds or not all(math.isfinite(v) for v in losses):
        raise AssertionError(f"{name}: non-finite or missing round losses {losses}")
    accs = [r.test_acc for r in hist.records]
    if not all(math.isfinite(a) and 0.0 <= a <= 1.0 for a in accs):
        raise AssertionError(f"{name}: bad test accuracies {accs}")
    want = {k: (n_rounds if k == kernel else 0) for k in KERNELS}
    if counts != want:
        raise AssertionError(f"{name}: launches {counts} in {n_rounds} rounds, want {want}")
    print(f"  launches in the run ({n_rounds} rounds): "
          + ", ".join(f"{k} {v}" for k, v in counts.items())
          + f"; peak device memory {torch.cuda.max_memory_allocated() / 2**20:.0f} MiB")
    return (counts[kernel] if kernel else 0), [r.wall_s for r in hist.records]


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
    return {"model": model_name, "codec": codec.name, "kernel": kernel,
            "launches": launches, "rounds": COMPRESSED_ROUNDS, "round_wall_s": walls,
            "aggregate_err": err, "payload_bytes": realized, "dense_bytes": 4 * n}, eng


def profile_round(name, eng, key, label):
    """Device time of one more round by kernel, from torch.profiler's CUDA
    activity (CUPTI), against the round's host wall time; ``key`` picks the
    hand kernel's rows by name."""
    from torch.profiler import ProfilerActivity, profile

    torch.cuda.synchronize()
    with profile(activities=[ProfilerActivity.CUDA]) as prof:
        t0 = time.perf_counter()
        float(eng.round()["loss"])
        wall = time.perf_counter() - t0
    rows = []
    for e in prof.key_averages():
        us = getattr(e, "self_device_time_total", None)
        if us is None:
            us = e.self_cuda_time_total
        if us > 0:
            rows.append((us, e.count, e.key))
    busy = sum(r[0] for r in rows) / 1e6
    rows.sort(reverse=True)
    agg = sum(r[0] for r in rows if key in r[2]) / 1e6
    print(f"  {name}: round wall {wall:.4f} s under the profiler, device busy {busy:.4f} s "
          f"(idle share {1 - busy / wall:.1%}), {sum(r[1] for r in rows)} device ops; "
          f"{label} {agg * 1e3:.4f} ms ({agg / wall:.4%} of the round, "
          f"{agg / busy:.4%} of device time)")
    for us, count, k in rows[:8]:
        print(f"    {us / 1e3:10.3f} ms {count:6d}x  {k[:90]}")
    return {"wall_s": wall, "device_busy_s": busy, "idle_share": 1 - busy / wall,
            "kernel_ms": agg * 1e3}


def print_ptxas(log):
    """One line per compiled kernel: registers and spill stores."""
    entry, spill = "?", "?"
    for line in log.splitlines():
        if "Compiling entry function" in line:
            mangled = line.split("'")[1]
            for base in ("packed_qagg_kernel", "qagg_kernel", "fedavg_agg_kernel",
                         "sparse_agg_kernel"):
                if base in mangled:
                    entry = base + "<" + mangled.split(base, 1)[1].split("EEv")[0][1:] + ">"
                    break
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
    built = build_all(["fedavg_agg", "quantized_agg", "sparse_agg"])
    print(f"built in {time.perf_counter() - t0:.2f} s wall")
    for src, res in built.items():
        print(f"  {src}: {res.path.name} nvcc {res.seconds:.2f} s (cached={res.cached})")
        print_ptxas(res.log)

    phase("3. kernel vs plain on the card")
    errs = {
        "fedavg_aggregate": check_fedavg_aggregate(),
        "quantized_aggregate": check_quantized_aggregate(),
        "packed_quantized_aggregate": check_packed_quantized_aggregate(),
        "sparse_aggregate": check_sparse_aggregate(),
    }

    phase("4. timing (CUDA events, median of 200, L2 flushed before each launch)")
    print(f"card: {smi}")
    timing = {"fedavg_aggregate": time_fedavg_aggregate(), **time_wire_kernels()}

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
    profile_round("mnist_cnn q8", eng_cnn_q8, "qagg_kernel<", "quantized_aggregate")

    phase("10. plain and q8 CNN rounds in turns (plain, q8, q8, plain), host clock to the synced loss")
    turns = []
    for name, eng in (("plain", eng_cnn), ("q8", eng_cnn_q8), ("q8", eng_cnn_q8),
                      ("plain", eng_cnn)):
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        float(eng.round()["loss"])
        turns.append((name, time.perf_counter() - t0))
        print(f"  {name:5s} round {turns[-1][1]:.4f} s")
    del eng_cnn, eng_cnn_q8, eng

    launches = {"fedavg_aggregate": launches_2nn + launches_cnn}
    for k in KERNELS[1:]:
        launches[k] = sum(lane["launches"] for lane in lanes if lane["kernel"] == k)
    sources = {
        "fedavg_aggregate": ("fedavg_agg.cu", "src/repro/kernels/fedavg_agg.py:77"),
        "quantized_aggregate": ("quantized_agg.cu", "src/repro/kernels/quantized_agg.py:81"),
        "packed_quantized_aggregate": ("quantized_agg.cu",
                                       "src/repro/kernels/quantized_agg.py:215"),
        "sparse_aggregate": ("sparse_agg.cu", "src/repro/kernels/sparse_agg.py:75"),
    }
    at = {
        "fedavg_aggregate": {"K": MAIN_K, "N": MAIN_N["mnist_cnn"], "dtype": "float32"},
        "quantized_aggregate": {"K": MAIN_K, "N": MAIN_N["mnist_cnn"], "codes": "uint8",
                                "chunk": CHUNK},
        "packed_quantized_aggregate": {"K": MAIN_K, "N": MAIN_N["mnist_cnn"], "bits": 4,
                                       "chunk": CHUNK},
        "sparse_aggregate": {"K": MAIN_K, "n": MAIN_N["mnist_cnn"], "keep_frac": TOPK,
                             "vals": "float32"},
    }
    kernels = []
    for k in KERNELS:
        cnn = timing[k]["mnist_cnn"]
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
            "lanes": [lane for lane in lanes if lane["kernel"] == k],
        })
    kernels[0]["round_wall_s"] = {"mnist_2nn": wall_2nn, "mnist_cnn": wall_cnn}
    kernels[1]["cnn_rounds_in_turns_s"] = turns
    print(f"\nchip_smoke: all phases passed in {time.perf_counter() - t_start:.1f} s")
    print(smi)
    print(json.dumps({"kernels": kernels}))
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": kind, "count": torch.cuda.device_count()}}))
    return 0


if __name__ == "__main__":
    sys.exit(main())
