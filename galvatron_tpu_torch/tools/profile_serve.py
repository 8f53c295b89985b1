"""Where a serve step's time goes on the GPU: one prefill and a few decode
ticks of the port's ServeEngine under ``torch.profiler``.

    python -m galvatron_tpu_torch.tools.profile_serve \\
        [--model_size llama-7b] [--num_layers 32] [--prompt_len 1490] \\
        [--slots 8] [--ticks 5] [--trace_dir chiprun_out]

Random weights from ``--seed``, bf16 compute. Every slot is filled with a
prompt of ``--prompt_len`` tokens first (so decode runs at full occupancy
in that bucket), then one prefill and ``--ticks`` decode ticks are traced.
For each phase it prints the wall time, the device-busy time (the sum of
kernel times the profiler records), the device's idle share, and the
kernels that take the most device time. Needs a CUDA GPU; raises without
one.
"""

from __future__ import annotations

import argparse
import json
import os
import time
from typing import Dict, List, Tuple

import numpy as np
import torch


def kernel_rows(prof) -> List[Tuple[str, float, int]]:
    """(kernel name, device ms, calls) for every device kernel the profiler
    recorded, largest first."""
    from torch.autograd import DeviceType

    rows = []
    for ev in prof.key_averages():
        # device-side events only: CPU ops also carry the time of the
        # kernels they launched, which would count it twice
        if ev.device_type == DeviceType.CUDA and ev.self_device_time_total > 0:
            rows.append((ev.key, ev.self_device_time_total / 1e3, ev.count))
    rows.sort(key=lambda r: -r[1])
    return rows


def _phase(prof, wall_ms: float, top: int) -> Dict:
    rows = kernel_rows(prof)
    busy = sum(r[1] for r in rows)
    return {
        "wall_ms": wall_ms,
        "device_busy_ms": busy,
        "idle_share": max(0.0, 1.0 - busy / wall_ms) if wall_ms > 0 else None,
        "top": [{"kernel": k[:120], "ms": ms, "share_of_busy": ms / busy if busy else None,
                 "calls": n} for k, ms, n in rows[:top]],
    }


def main(argv: List[str] = None) -> Dict:
    p = argparse.ArgumentParser("galvatron_tpu_torch-profile_serve")
    p.add_argument("--model_size", default="llama-7b")
    p.add_argument("--num_layers", type=int, default=None)
    p.add_argument("--prompt_len", type=int, default=1490)
    p.add_argument("--slots", type=int, default=8)
    p.add_argument("--page_size", type=int, default=128)
    p.add_argument("--ticks", type=int, default=5)
    p.add_argument("--top", type=int, default=12)
    p.add_argument("--seed", type=int, default=1234)
    p.add_argument("--trace_dir", default=None)
    args = p.parse_args(argv)
    if not torch.cuda.is_available():
        raise RuntimeError("profile_serve needs a CUDA GPU (torch.cuda.is_available() is False)")

    from torch.profiler import ProfilerActivity, profile

    from galvatron_tpu_torch.config.strategy import HybridParallelConfig
    from galvatron_tpu_torch.models.llama import llama_config
    from galvatron_tpu_torch.runtime.model_api import construct_hybrid_parallel_model
    from galvatron_tpu_torch.serve.engine import ServeEngine
    from galvatron_tpu_torch.serve.kv_cache import KVCacheConfig, bucket_pages

    torch.backends.cuda.matmul.allow_tf32 = False
    dev = torch.device("cuda", torch.cuda.current_device())
    overrides = {"compute_dtype": torch.bfloat16}
    if args.num_layers:
        overrides["num_layers"] = args.num_layers
    cfg = llama_config(args.model_size, **overrides)
    model = construct_hybrid_parallel_model(
        cfg, HybridParallelConfig.uniform(1, cfg.num_layers), dev, mode="serve")
    params = model.init_params(args.seed)[0]
    max_pages = -(-cfg.max_seq_len // args.page_size)
    kv = KVCacheConfig(max_slots=args.slots, page_size=args.page_size, max_pages=max_pages)
    engine = ServeEngine(cfg, params, kv, device=dev, rng_seed=args.seed)
    rng = np.random.default_rng(args.seed)
    prompt = [int(t) for t in rng.integers(0, cfg.vocab_size, size=args.prompt_len)]
    toks = np.zeros((args.slots,), np.int32)
    for slot in range(args.slots):
        toks[slot], _ = engine.prefill(prompt, slot)
    pages = bucket_pages(args.prompt_len + args.ticks + 1, args.page_size, max_pages)
    active = np.ones((args.slots,), bool)
    engine.decode_step(toks, active, pages)  # warm the decode path
    torch.cuda.synchronize()

    acts = [ProfilerActivity.CPU, ProfilerActivity.CUDA]
    out = {"device": torch.cuda.get_device_name(0), "model": args.model_size,
           "num_layers": cfg.num_layers, "prompt_len": args.prompt_len,
           "slots": args.slots, "ticks": args.ticks, "decode_pages": pages}
    with profile(activities=acts) as prof:
        t0 = time.perf_counter()
        engine.prefill(prompt, 0)
        torch.cuda.synchronize()
        wall = (time.perf_counter() - t0) * 1e3
    out["prefill"] = _phase(prof, wall, args.top)
    if args.trace_dir:
        os.makedirs(args.trace_dir, exist_ok=True)
        prof.export_chrome_trace(os.path.join(args.trace_dir, "profile_serve_prefill.json"))
    with profile(activities=acts) as prof:
        t0 = time.perf_counter()
        for _ in range(args.ticks):
            toks, _ = engine.decode_step(toks, active, pages)
        torch.cuda.synchronize()
        wall = (time.perf_counter() - t0) * 1e3
    out["decode"] = _phase(prof, wall, args.top)
    out["decode"]["per_tick_ms"] = wall / args.ticks
    if args.trace_dir:
        prof.export_chrome_trace(os.path.join(args.trace_dir, "profile_serve_decode.json"))
    for name in ("prefill", "decode"):
        ph = out[name]
        print("%s: wall %.2f ms, device busy %.2f ms, idle share %.3f" % (
            name, ph["wall_ms"], ph["device_busy_ms"], ph["idle_share"]))
        for row in ph["top"]:
            print("  %8.3f ms %5.1f%% x%-5d %s" % (row["ms"], 100 * row["share_of_busy"],
                                                 row["calls"], row["kernel"]))
    print(json.dumps(out))
    return out


if __name__ == "__main__":
    main()
