"""Whether ``chip_smoke.py``'s profile reader (``profiled_device_ops``: the
profiler's raw kineto events, user annotations dropped) sees the same device
ops as ``prof.events()``'s device events, on profiles that carry
``record_function`` ranges.

Two workloads:

- one xLSTM-350M prefill, whole and in bf16, B = 4 x 2048 tokens (ranges
  ``mlstm_chunkwise`` and ``slstm_scan``; ~144,000 device ops), profiled
  with CUDA activity alone, as ``chip_smoke.device_profile`` profiles it
  in phase 29;
- one Gemma-2B training step, B = 2 x 2048 tokens, AdamW (ranges
  ``flash_attention_bwd``, ``fused_cross_entropy_bwd``,
  ``optimizer_update``), profiled with CUDA activity alone and with CPU
  and CUDA activity, as phase 17 profiles it.

For each profile: both readers' op counts and device busy seconds (the
union of the ops' intervals), how many of ``prof.events()``'s device events
are the ranges' own (user annotations), whether the two readers' ops are the
same multiset of (name, duration, stream) once those are set aside, and the
seconds each reader took. Needs one CUDA card:

    PYTHONPATH=src python scripts/compare_profile_readers.py --json out.json

The last line printed is one JSON object: a row a (workload, activity).
"""
from __future__ import annotations

import argparse
import json
import sys
import time
from pathlib import Path

import numpy as np
import torch

sys.path.insert(0, str(Path(__file__).resolve().parents[1]))
import chip_smoke as cs  # noqa: E402

RANGES = ("mlstm_chunkwise", "slstm_scan", "flash_attention_bwd", "fused_cross_entropy_bwd",
          "optimizer_update")


def xlstm_prefill():
    from repro_torch.configs import get_config
    from repro_torch.models.transformer import TransformerLM

    model = TransformerLM(get_config("xlstm-350m"), device="cuda")
    params = model.init(0)
    prompt = cs.serving_prompt(model.cfg, cs.SERVE_BATCH, cs.PROMPT)

    def run():
        model.prefill(params, prompt, cache_len=cs.PROMPT + cs.SERVE_TOKENS)

    return run


def gemma_step():
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
    batch = {k: torch.from_numpy(r.integers(0, model.cfg.vocab_size, (cs.TRAIN_B, cs.TRAIN_S))
                                 .astype(np.int32)).cuda() for k in ("tokens", "labels")}

    def run():
        _, box["state"], m = step(params, box["state"], batch)
        float(m["loss"])

    return run


def key(e):
    return (e.name, round(e.time_range.elapsed_us(), 3), e.device_resource_id)


def compare(label, fn, activities):
    from torch.autograd import DeviceType
    from torch.profiler import profile

    fn()
    torch.cuda.synchronize()
    with profile(activities=activities) as prof:
        fn()
        torch.cuda.synchronize()
    t0 = time.perf_counter()
    new = cs.profiled_device_ops(prof)
    new_s = time.perf_counter() - t0
    t0 = time.perf_counter()
    old = [e for e in prof.events() if e.device_type == DeviceType.CUDA]
    old_s = time.perf_counter() - t0
    annotations = [e for e in old if e.name in RANGES]
    old_ops = [e for e in old if e.name not in RANGES]
    busy = {name: cs.busy_seconds((e.time_range.start, e.time_range.end) for e in ops)
            for name, ops in (("new", new), ("old", old), ("old without ranges", old_ops))}
    same = sorted(map(key, new)) == sorted(map(key, old_ops))
    row = {"workload": label, "activity": "+".join(a.name for a in activities),
           "new_ops": len(new), "old_ops": len(old), "old_range_events": len(annotations),
           "same_ops_without_ranges": same, "busy_s": busy,
           "new_reader_s": new_s, "old_reader_s": old_s}
    print(f"{label}, {row['activity']}: raw events {len(new)} ops, busy {busy['new']:.6f} s "
          f"({new_s:.2f} s to read); prof.events() {len(old)} device events, of them "
          f"{len(annotations)} the ranges' own, busy {busy['old']:.6f} s with them and "
          f"{busy['old without ranges']:.6f} s without ({old_s:.2f} s to read); the same ops "
          f"without the ranges: {same}", flush=True)
    return row


def main(argv=None):
    from torch.profiler import ProfilerActivity

    from repro_torch.kernels.build import build_all

    ap = argparse.ArgumentParser()
    ap.add_argument("--json", default=None)
    args = ap.parse_args(argv)
    card = cs.nvidia_smi_line()
    print(card)
    build_all(["flash_attention", "ce_loss"])
    rows = []
    cuda, both = [ProfilerActivity.CUDA], [ProfilerActivity.CPU, ProfilerActivity.CUDA]
    for label, make, profiles in (("xlstm-350m prefill", xlstm_prefill, (cuda,)),
                                  ("gemma-2b train step", gemma_step, (cuda, both))):
        fn = make()
        for activities in profiles:
            rows.append(compare(label, fn, activities))
        del fn
        cs.free_card()
    out = {"card": card, "rows": rows}
    if args.json:
        with open(args.json, "w") as f:
            json.dump(out, f)
    print(json.dumps(out))


if __name__ == "__main__":
    main()
