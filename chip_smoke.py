#!/usr/bin/env python3
"""Drive the PyTorch port (``src/repro_torch``) on one NVIDIA card.

    python3 chip_smoke.py        # from the repository root; needs one CUDA card

Phases, in order, each printing its own lines:

1. environment: the card's name and power limit, torch and CUDA versions;
   TF32 is switched off so the port is compared in full fp32;
2. build: nvcc builds every kernel of the main path from ``src``, and the
   build time and ``-Xptxas -v`` register/spill lines are printed;
3. each kernel against its plain PyTorch version on the card, over a sweep
   of shapes and dtypes, plus the refusals its wrapper must make;
4. timing at the main path's shapes: kernel, plain version, one library
   call as a yardstick, and the bound (CUDA events, L2 flushed);
5. the main path, the paper's MNIST 2NN non-IID cell at full size through
   ``RoundEngine(...).run``: one round on the card is first held against
   the same round on the CPU, then the rounds are run and timed;
6. the same for the MNIST CNN;
7. where the time goes: one more round of each under torch.profiler,
   device time by kernel against the round's wall time.

The last three lines are the card's ``nvidia-smi`` name and power limit, a
``{"kernels": [...]}`` record and ``{"ok": true, "device": {...}}``. Any
failure exits non-zero before those lines; so does a machine without a
card.
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
HBM_BYTES_PER_S = 3.35e12
FP32_FLOPS = 67e12
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


# ---------------------------------------------------------------------------
# phases 5-6: the main path
# ---------------------------------------------------------------------------

def host_vector(tree) -> torch.Tensor:
    from repro_torch.utils.tree import tree_map, tree_ravel

    return tree_ravel(tree_map(lambda p: p.detach().cpu().double(), tree))[0]


def main_path(model_name, data):
    from repro_torch.core.engine import (
        RoundBatch,
        RoundEngine,
        RoundState,
        build_simulation_round_step,
    )
    from repro_torch.core.fedavg import FedAvgConfig, sample_clients
    from repro_torch.core.simulation import make_eval_fn
    from repro_torch.data.partition import partition_pathological_noniid
    from repro_torch.kernels.fedavg_agg import fedavg_aggregate
    from repro_torch.models import paper
    from repro_torch.utils.tree import tree_leaves, tree_map

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
                      device="cuda")
    print(f"  {spec['name']}: {len(clients)} clients x {int(split.client_sizes[0])} examples, "
          f"C={cfg.C} E={cfg.E} B={cfg.B} lr={cfg.lr}, {n_params} params, "
          f"{eng.packed.max_real_steps_per_epoch * cfg.E} steps/round")

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

    # The main path itself: counts from zero, RoundEngine.run, counts read.
    n_rounds = ROUNDS[model_name]
    fedavg_aggregate.launches = 0
    hist = eng.run(n_rounds, eval_every=1)
    torch.cuda.synchronize()
    launches = fedavg_aggregate.launches
    for r in hist.records:
        print(f"  round {r.round}: loss {r.train_loss:.6f} test_acc {r.test_acc:.4f} "
              f"test_loss {r.test_loss:.6f} wall_s {r.wall_s:.4f}")
    losses = [r.train_loss for r in hist.records]
    if len(hist.records) != n_rounds or not all(math.isfinite(v) for v in losses):
        raise AssertionError(f"{model_name}: non-finite or missing round losses {losses}")
    if launches != n_rounds:
        raise AssertionError(f"{model_name}: fedavg_aggregate launched {launches} times "
                             f"in {n_rounds} rounds")
    accs = [r.test_acc for r in hist.records]
    if not all(math.isfinite(a) and 0.0 <= a <= 1.0 for a in accs):
        raise AssertionError(f"{model_name}: bad test accuracies {accs}")
    print(f"  fedavg_aggregate launches in the run: {launches} (rounds {n_rounds}); "
          f"peak device memory {torch.cuda.max_memory_allocated() / 2**20:.0f} MiB")
    return launches, [r.wall_s for r in hist.records], eng


def profile_round(name, eng):
    """Device time of one more round by kernel, from torch.profiler's CUDA
    activity (CUPTI), against the round's host wall time."""
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
    agg = sum(r[0] for r in rows if "fedavg_agg" in r[2]) / 1e6
    print(f"  {name}: round wall {wall:.4f} s under the profiler, device busy {busy:.4f} s "
          f"(idle share {1 - busy / wall:.1%}), {sum(r[1] for r in rows)} device ops; "
          f"fedavg_aggregate {agg * 1e3:.4f} ms ({agg / wall:.4%} of the round)")
    for us, count, key in rows[:8]:
        print(f"    {us / 1e3:10.3f} ms {count:6d}x  {key[:90]}")
    return {"wall_s": wall, "device_busy_s": busy, "idle_share": 1 - busy / wall}


def main() -> int:
    if not torch.cuda.is_available():
        print("chip_smoke: torch.cuda.is_available() is False: this script needs a CUDA card",
              file=sys.stderr)
        return 2

    from repro_torch.data.synthetic import make_image_classification
    from repro_torch.kernels.build import build

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

    phase("2. build")
    res = build("fedavg_agg")
    print(f"fedavg_agg: {res.path.name} built in {res.seconds:.2f} s (cached={res.cached})")
    for line in res.log.splitlines():
        if "ptxas" in line and ("registers" in line or "spill" in line or "Compiling" in line):
            print(f"  {line.strip()}")

    phase("3. kernel vs plain on the card")
    main_err = check_fedavg_aggregate()

    phase("4. timing (CUDA events, median of 200, L2 flushed before each launch)")
    print(f"card: {smi}")
    timing = time_fedavg_aggregate()

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
        profile_round(name, eng)

    cnn = timing["mnist_cnn"]
    record = {"kernels": [{
        "name": "fedavg_aggregate",
        "route": "cuda",
        "source": "src/repro_torch/kernels/csrc/fedavg_agg.cu",
        "replaces": "src/repro/kernels/fedavg_agg.py:77",
        "launches": launches_2nn + launches_cnn,
        "max_abs_err": main_err,
        "ms": cnn["ms"],
        "plain_ms": cnn["plain_ms"],
        "bound_ms": cnn["bound_ms"],
        "bound_by": cnn["bound_by"],
        "library_ms": cnn["library_ms"],
        "at": {"K": MAIN_K, "N": MAIN_N["mnist_cnn"], "dtype": "float32"},
        "per_shape": timing,
        "round_wall_s": {"mnist_2nn": wall_2nn, "mnist_cnn": wall_cnn},
    }]}
    print()
    print(smi)
    print(json.dumps(record))
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": kind, "count": torch.cuda.device_count()}}))
    return 0


if __name__ == "__main__":
    sys.exit(main())
