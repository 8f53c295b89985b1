"""Runtime (in-training) profiler: iteration timing, throughput, memory.

Port of ``galvatron_tpu/profiler/runtime.py``'s `RuntimeProfiler` for the
synchronous training loop. ``start(it)`` / ``end(it, n_samples)`` bracket
each step; on a CUDA device ``end`` synchronises first, so an iteration's
time is the device's, and peak memory is ``torch.cuda.max_memory_allocated``
counted from the start of iteration 0 (the model and optimizer state are
resident by then; earlier work in the process is not counted).
Iterations inside the warmup window are timed but left out of the summary.
The summary carries the reference's keys (``avg_iter_ms``, ``p50_iter_ms``,
``steady_step_ms``, ``samples_per_s``, ``peak_hbm_mb``, ``iters`` and, with
the model FLOPs and the peak set, ``model_flops_per_step``,
``model_flops_per_s`` and ``mfu``).
"""

from __future__ import annotations

import time
from dataclasses import dataclass, field
from typing import Dict, List, Optional

import numpy as np
import torch

from galvatron_tpu_torch.obs import flops as obs_flops


@dataclass
class RuntimeProfiler:
    warmup: int = 2
    device: torch.device = field(default_factory=lambda: torch.device("cpu"))
    model_flops: Optional[float] = None  # model FLOPs per optimizer step
    peak_flops: Optional[float] = None  # device peak FLOP/s (registry)
    iter_times_ms: List[float] = field(default_factory=list)
    all_times_ms: List[float] = field(default_factory=list)
    samples: List[int] = field(default_factory=list)
    _t0s: Dict[int, float] = field(default_factory=dict)

    def _sync(self):
        if self.device.type == "cuda":
            torch.cuda.synchronize(self.device)

    def start(self, iteration: int):
        if iteration == 0 and self.device.type == "cuda":
            torch.cuda.reset_peak_memory_stats(self.device)
        self._sync()
        self._t0s[iteration] = time.perf_counter()

    def end(self, iteration: int, n_samples: int = 0) -> float:
        self._sync()
        dt = (time.perf_counter() - self._t0s.pop(iteration)) * 1e3
        self.all_times_ms.append(dt)
        if iteration >= self.warmup:
            self.iter_times_ms.append(dt)
            self.samples.append(n_samples)
        return dt

    def peak_memory_mb(self) -> float:
        if self.device.type != "cuda":
            return 0.0
        return torch.cuda.max_memory_allocated(self.device) / 2**20

    def summary(self) -> Dict[str, float]:
        if not self.iter_times_ms:
            return {"avg_iter_ms": 0.0, "samples_per_s": 0.0, "iters": 0}
        total_ms = float(np.sum(self.iter_times_ms))
        out = {
            "avg_iter_ms": float(np.mean(self.iter_times_ms)),
            "p50_iter_ms": float(np.percentile(self.iter_times_ms, 50)),
            "steady_step_ms": float(np.percentile(self.iter_times_ms, 50)),
            "samples_per_s": float(np.sum(self.samples)) / (total_ms / 1e3) if total_ms > 0 else 0.0,
            "peak_hbm_mb": self.peak_memory_mb(),
            "iters": len(self.iter_times_ms),
        }
        if self.model_flops:
            out["model_flops_per_step"] = self.model_flops
            fps = obs_flops.flops_per_s(self.model_flops, out["avg_iter_ms"])
            if fps is not None:
                out["model_flops_per_s"] = fps
            util = obs_flops.mfu(self.model_flops, out["avg_iter_ms"], self.peak_flops)
            if util is not None:
                out["mfu"] = util
        return out

    def log_iteration(self, iteration: int, metrics: Optional[dict] = None, print_fn=print):
        """One line per logged iteration: its time and scalar metrics."""
        if not self.all_times_ms:
            return
        extra = ""
        if metrics:
            extra = " " + " ".join("%s=%.4g" % (k, float(v)) for k, v in metrics.items())
        print_fn("iter %4d | %8.2f ms%s" % (iteration, self.all_times_ms[-1], extra))
