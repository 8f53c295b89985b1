"""Times the flash-attention kernels at the shapes of the port's main paths.

    python -m galvatron_tpu_torch.tools.bench_flash [--baseline DIR] [--out FILE]

Shapes: bf16, 32 heads, head_dim 128, causal, no padding; B=1 at the serve
path's prefill buckets (S 128-1536, multiples of the 128-token page) and at
S=2048, and B=4 at S=2048 (the train path's micro-batch). For each shape,
the forward and the backward (the backward's inputs from one forward) are
timed three ways:

* ``single``: the median of 25 single calls, each between its own events,
  so the host's launch overhead counts when it exceeds the kernel's time;
* ``stream``: 20 calls back to back between two events, divided by 20,
  median of 5 such runs: the time per call once the host runs ahead;
* ``device``: the device time of the kernels those 20 calls launched, from
  ``torch.profiler``, per call: the kernel's own time, which at small
  shapes lies under the host's launch overhead in the other two.

Beside each: ``torch.nn.functional.scaled_dot_product_attention`` (forward,
and autograd of it for the backward) on the same inputs as a yardstick,
which the port never calls.

``--baseline DIR`` also times the wrappers of another checkout of the repo
(``DIR/galvatron_tpu_torch/ops/flash_attention.py``, loaded as a separate
module; its kernels build under ``DIR/build``), in the order baseline, this
tree, this tree, baseline, and reports the mean of each pair. Needs a CUDA
GPU and nvcc; raises without them.
"""

from __future__ import annotations

import argparse
import importlib.util
import json
import os
import statistics
import subprocess
from typing import Callable, Dict, List

import torch

SHAPES = [(1, s) for s in (128, 256, 512, 768, 1024, 1536, 2048)] + [(4, 2048)]
HEADS, HEAD_DIM = 32, 128


def time_single(fn: Callable, reps: int = 25, warmup: int = 3) -> float:
    for _ in range(warmup):
        fn()
    torch.cuda.synchronize()
    times = []
    for _ in range(reps):
        start, end = torch.cuda.Event(enable_timing=True), torch.cuda.Event(enable_timing=True)
        start.record()
        fn()
        end.record()
        torch.cuda.synchronize()
        times.append(start.elapsed_time(end))
    return statistics.median(times)


def time_stream(fn: Callable, calls: int = 20, runs: int = 5) -> float:
    fn()
    torch.cuda.synchronize()
    times = []
    for _ in range(runs):
        start, end = torch.cuda.Event(enable_timing=True), torch.cuda.Event(enable_timing=True)
        start.record()
        for _ in range(calls):
            fn()
        end.record()
        torch.cuda.synchronize()
        times.append(start.elapsed_time(end) / calls)
    return statistics.median(times)


def time_device(fn: Callable, calls: int = 20) -> float:
    from torch.profiler import ProfilerActivity, profile

    from galvatron_tpu_torch.tools.profile_serve import kernel_rows

    fn()
    torch.cuda.synchronize()
    with profile(activities=[ProfilerActivity.CUDA]) as prof:
        for _ in range(calls):
            fn()
        torch.cuda.synchronize()
    return sum(ms for _, ms, _ in kernel_rows(prof)) / calls


def load_wrappers(root: str):
    """The flash-attention module of the checkout at `root`, as its own module."""
    path = os.path.join(root, "galvatron_tpu_torch", "ops", "flash_attention.py")
    spec = importlib.util.spec_from_file_location("baseline_flash_attention", path)
    mod = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(mod)
    return mod


def both(fn: Callable) -> Dict[str, float]:
    return {"single": time_single(fn), "stream": time_stream(fn), "device": time_device(fn)}


def bench_shape(b: int, s: int, impls: Dict[str, object], gen: torch.Generator) -> Dict:
    q, k, v, do = (torch.randn((b, s, HEADS, HEAD_DIM), generator=gen, device="cuda")
                   .to(torch.bfloat16) for _ in range(4))
    scale = HEAD_DIM ** -0.5
    row = {"shape": [b, s, HEADS, HEAD_DIM], "fwd": {}, "bwd": {}}
    order = ["baseline", "this", "this", "baseline"] if "baseline" in impls else ["this"]
    for name in order:
        mod = impls[name]
        out, lse = mod.flash_attention_fwd(q, k, v, causal=True, sm_scale=scale)
        for what, fn in (
            ("fwd", lambda: mod.flash_attention_fwd(q, k, v, causal=True, sm_scale=scale)),
            ("bwd", lambda: mod.flash_attention_bwd(q, k, v, out, lse, do, causal=True,
                                                    sm_scale=scale)),
        ):
            row[what].setdefault(name, []).append(both(fn))
    for what in ("fwd", "bwd"):
        for name, runs in row[what].items():
            row[what][name] = {m: sum(r[m] for r in runs) / len(runs) for m in runs[0]}
    if getattr(impls["this"].flash_attention_fwd, "last_route", None):
        row["route"] = {"fwd": impls["this"].flash_attention_fwd.last_route,
                        "bwd": impls["this"].flash_attention_bwd.last_route}
    qt, kt, vt = (x.transpose(1, 2).detach().requires_grad_() for x in (q, k, v))
    sdpa = torch.nn.functional.scaled_dot_product_attention
    row["fwd"]["sdpa"] = both(lambda: sdpa(qt, kt, vt, is_causal=True, scale=scale))
    lo = sdpa(qt, kt, vt, is_causal=True, scale=scale)
    dot = do.transpose(1, 2)
    row["bwd"]["sdpa"] = both(lambda: torch.autograd.grad(lo, (qt, kt, vt), dot,
                                                          retain_graph=True))
    return row


def main(argv: List[str] = None) -> Dict:
    p = argparse.ArgumentParser("galvatron_tpu_torch-bench_flash")
    p.add_argument("--baseline", default=None, help="root of another checkout to time beside")
    p.add_argument("--out", default=None, help="write the results here as JSON")
    args = p.parse_args(argv)
    if not torch.cuda.is_available():
        raise RuntimeError("bench_flash needs a CUDA GPU (torch.cuda.is_available() is False)")
    from galvatron_tpu_torch.ops import flash_attention as this

    impls = {"this": this}
    if args.baseline:
        impls["baseline"] = load_wrappers(args.baseline)
    card = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
                          capture_output=True, text=True).stdout.strip().splitlines()[0]
    gen = torch.Generator(device="cuda")
    gen.manual_seed(0)
    rows = [bench_shape(b, s, impls, gen) for b, s in SHAPES]
    result = {"card": card, "torch": torch.__version__, "rows": rows}
    for r in rows:
        print("B=%d S=%d %s" % (r["shape"][0], r["shape"][1], " | ".join(
            "%s %s" % (what, ", ".join("%s %.4f/%.4f/%.4f" % (n, t["single"], t["stream"],
                                                              t["device"])
                                       for n, t in r[what].items()))
            for what in ("fwd", "bwd"))), flush=True)
    if args.out:
        os.makedirs(os.path.dirname(os.path.abspath(args.out)), exist_ok=True)
        with open(args.out, "w") as f:
            json.dump(result, f, indent=1)
    print(card)
    return result


if __name__ == "__main__":
    main()
