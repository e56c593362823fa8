#!/usr/bin/env python3
"""Where the device time of the port's paged serving goes, on one card.

    python3 tools/torch_serve_profile.py [--quantized int8|fp8 | --moe |
                                          --lora] [--dense | --legacy]

Serves ``chip_smoke.py``'s workload (``GPTForCausalLM(gpt_small())``,
seeded random weights, 16 requests through ``GenerationEngine`` with
batch 8, buckets 16/48, page 16, speculative_k 4; with ``--quantized``
through the int8 or fp8 engine; with ``--moe`` the MoE model of phase M4,
``gpt_small(moe_experts=8, moe_top_k=2, moe_capacity_factor=8.0)``; with
``--dense`` through the default engine, dense-ring continuous batching,
as phase D1 builds it, with ``--legacy`` through the legacy scheduler as
D2 does) once to warm up, then once more under ``torch.profiler`` (CPU +
CUDA activities).  ``--lora`` serves phase A5's 16-adapter engine
instead: bench.py's multi-LoRA config (4 layers, hidden 256, 16 slots of
rank 8, ``chip_smoke.lora_bench_model`` / ``lora_bench_engine``) with
``RequestTrace.synthetic()``'s 48 requests round-robin over the slots.
It prints:

* the window's wall time and the device-busy share (summed device time of
  every kernel and copy over the wall time — one stream, so no overlap);
* device time by kernel, largest first, grouped into the port's
  ``paged_flash_decode``, ``quantized_matmul`` and ``grouped_matmul``
  kernels, matrix products and everything else.

Numbers under the profiler run slower than ``chip_smoke.py``'s; read the
shares, not the absolute times.  Exits non-zero without a card.
"""
from __future__ import annotations

import argparse
import os
import sys
import time

sys.path.insert(0, os.path.dirname(os.path.dirname(os.path.abspath(
    __file__))))


def _group(name: str) -> str:
    if "paged_decode_kernel" in name or "paged_split_kernel" in name:
        return "paged_flash_decode"
    if "qmm_kernel" in name:
        return "quantized_matmul"
    if any(k in name for k in ("gmm_bf16_kernel", "gmm_bf16_wgmma_kernel",
                               "gmm_f32_kernel", "gmm_f32_small_kernel")):
        return "grouped_matmul"
    low = name.lower()
    if "gemm" in low or "cutlass" in low or "matmul" in low:
        return "matmul"
    if "memcpy" in low or "memset" in low:
        return "copy"
    return "other"


def main() -> int:
    ap = argparse.ArgumentParser(description=__doc__.split("\n")[0])
    which = ap.add_mutually_exclusive_group()
    which.add_argument("--quantized", choices=("int8", "fp8"), default=None,
                       help="profile the int8 or fp8 engine (default: "
                       "float)")
    which.add_argument("--moe", action="store_true",
                       help="profile the MoE model's engine")
    which.add_argument("--lora", action="store_true",
                       help="profile phase A5's 16-adapter engine")
    mode = ap.add_mutually_exclusive_group()
    mode.add_argument("--dense", action="store_true",
                      help="the default engine (dense ring, continuous)")
    mode.add_argument("--legacy", action="store_true",
                      help="the legacy run-batch-to-completion scheduler")
    opts = ap.parse_args()
    if (opts.moe or opts.lora) and (opts.dense or opts.legacy):
        ap.error("--moe and --lora profile paged engines only")
    import torch
    from torch.profiler import ProfilerActivity, profile

    if not torch.cuda.is_available():
        print("torch_serve_profile: no CUDA card visible", file=sys.stderr)
        return 2
    import chip_smoke as cs
    from paddle_tpu_torch.models.gpt import GPTForCausalLM, gpt_small
    from paddle_tpu_torch.serving import GenerationEngine

    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    gpu = cs.gpu_line()
    if opts.moe:
        model = cs.moe_model(torch, "float32",
                             moe_capacity_factor=cs.MOE_SERVE_CF)
    elif opts.lora:
        model = cs.lora_bench_model(torch, cs.LORA_CAP)
    else:
        model = GPTForCausalLM(gpt_small(dropout=0.0), device="cuda",
                               generator=torch.Generator().manual_seed(
                                   cs.SEED))
    reqs = cs.requests()
    engine = dict(cs.ENGINE)
    if opts.dense or opts.legacy:
        engine = dict(prompt_buckets=engine["prompt_buckets"],
                      batch_size=engine["batch_size"])
        if opts.legacy:
            engine["continuous"] = False
        reqs = [(p, n, {}) for p, n, _ in reqs]  # no shared prefixes
    if opts.lora:
        from paddle_tpu_torch.tuning import RequestTrace

        eng = cs.lora_bench_engine(model, cs.LORA_CAP)
        trace = RequestTrace.synthetic()

        def run():
            cs.lora_trace_pass(eng, trace, cs.LORA_CAP)
    else:
        eng = GenerationEngine(model, name="profile",
                               quantized=opts.quantized, **engine)

        def run():
            for f in [eng.submit(p, n, **kw) for p, n, kw in reqs]:
                f.result(600)
    with eng:
        eng.warmup()
        run()
        st0 = eng.stats()
        torch.cuda.synchronize()
        with profile(activities=[ProfilerActivity.CPU,
                                 ProfilerActivity.CUDA]) as prof:
            t0 = time.perf_counter()
            run()
            torch.cuda.synchronize()
            wall_us = (time.perf_counter() - t0) * 1e6
        st = eng.stats()
    steps = st["decode_steps"] - st0["decode_steps"]
    admits = st["batches"] - st0["batches"]
    layout = ("legacy" if opts.legacy else "dense" if opts.dense
              else "paged")
    rows = []
    for e in prof.key_averages():
        if "CUDA" not in str(e.device_type):
            continue
        us = getattr(e, "self_device_time_total", None)
        if us is None:
            us = e.self_cuda_time_total
        rows.append((float(us), e.count, e.key))
    rows.sort(reverse=True)
    busy = sum(r[0] for r in rows)
    kind = ("moe" if opts.moe else "lora16" if opts.lora
            else opts.quantized or "float")
    print(f"profile[{gpu}]: engine {kind} {layout}, window "
          f"{wall_us / 1e3:.1f} ms, "
          f"{admits} {'batches' if opts.legacy else 'admission calls'} + "
          f"{steps} decode steps, device busy "
          f"{busy / 1e3:.1f} ms = {100 * busy / wall_us:.1f}% of the window")
    groups = {}
    for us, n, name in rows:
        g = groups.setdefault(_group(name), [0.0, 0])
        g[0] += us
        g[1] += n
    for g, (us, n) in sorted(groups.items(), key=lambda kv: -kv[1][0]):
        print(f"profile[{gpu}]: {g:20s} {us / 1e3:9.2f} ms device "
              f"({100 * us / busy:5.1f}% of busy, "
              f"{100 * us / wall_us:5.1f}% of window), {n} launches")
    for us, n, name in rows[:15]:
        print(f"profile:   {us / 1e3:9.3f} ms  x{n:<6d} {name[:110]}")
    return 0


if __name__ == "__main__":
    sys.exit(main())
