"""Runtime (in-training) profiler: iteration timing, throughput, memory.

Port of ``galvatron_tpu/profiler/runtime.py``: `device_memory_stats` and
`RuntimeProfiler` for the train loop, which keeps up to ``--inflight_steps``
steps undrained. ``start(it)`` / ``dispatched(it)`` bracket the step call
and ``end(it, n_samples)`` runs when the step is drained, possibly later.
Each bracket end is a mark on the device's timeline (a CUDA event; on the
CPU, which runs the step synchronously, the host's clock), so two times per
step are read however late the host drains it:

- the step's **period**, from the previous step's end mark to its own: all
  the time the step took end to end, the device's idle while it waited for
  the host (data, the guard's read, logging) included. Work between steps
  that is not training — an eval pass, a checkpoint, a rollback — runs
  inside ``boundary()``, and the next period starts where it ends. The
  post-warmup periods add up to the wall time of the train steps; the
  reference's keys come from them: ``avg_iter_ms``, ``p50_iter_ms``,
  ``steady_step_ms`` (the median), ``samples_per_s`` (all the samples over
  the periods' sum) and, with the model FLOPs and the peak set,
  ``model_flops_per_step``, ``model_flops_per_s`` and ``mfu`` (from the
  mean period);
- the step's **device time**, from the point the stream reached the step to
  the end of its last kernel (``device_step_ms``, the median; on the CPU
  the host's time in the call). The period less this is the device's idle
  before the step.

``end`` records how long the host blocked (``host_blocked_ms``);
``loop_fence`` records the fenced post-warmup wall time of the whole loop
(``loop_wall_ms``, ``wall_ms_per_iter``, ``steps_per_s``; eval and
checkpoint passes included). Peak memory is
``torch.cuda.max_memory_allocated`` counted from the start of iteration 0;
``profile_memory`` keeps stage-tagged snapshots of `device_memory_stats`.
Iterations inside the warmup window are timed but left out of the summary.
``log_iteration`` prints one line per logged iteration and, with
``log_dir`` (``cli train --train_log_dir``), tees it to
``<log_dir>/train_<model_name>.log``, opened once and held until `close`.
"""

from __future__ import annotations

import contextlib
import os
import time
from dataclasses import dataclass, field
from typing import Dict, List, Optional

import numpy as np
import torch

from galvatron_tpu_torch.obs import flops as obs_flops


def device_memory_stats(device=None) -> Dict[str, float]:
    """Current/peak allocated bytes and the device's capacity
    (``torch.cuda.memory_stats``); zeros on the CPU."""
    device = torch.device(device) if device is not None else None
    if device is None or device.type != "cuda":
        if device is not None or not torch.cuda.is_available():
            return {"bytes_in_use": 0.0, "peak_bytes_in_use": 0.0, "bytes_limit": 0.0}
        device = torch.device("cuda", torch.cuda.current_device())
    stats = torch.cuda.memory_stats(device)
    return {
        "bytes_in_use": float(stats.get("allocated_bytes.all.current", 0)),
        "peak_bytes_in_use": float(stats.get("allocated_bytes.all.peak", 0)),
        "bytes_limit": float(torch.cuda.get_device_properties(device).total_memory),
    }


@dataclass
class RuntimeProfiler:
    warmup: int = 2
    device: torch.device = field(default_factory=lambda: torch.device("cpu"))
    model_flops: Optional[float] = None  # model FLOPs per optimizer step
    peak_flops: Optional[float] = None  # device peak FLOP/s (registry)
    model_name: str = "model"
    log_dir: Optional[str] = None  # tee the iteration lines to <log_dir>/train_<model_name>.log
    iter_times_ms: List[float] = field(default_factory=list)  # post-warmup periods
    all_times_ms: List[float] = field(default_factory=list)  # every period
    device_times_ms: List[float] = field(default_factory=list)  # post-warmup
    samples: List[int] = field(default_factory=list)
    dispatch_ms: List[float] = field(default_factory=list)
    host_blocked_ms: List[float] = field(default_factory=list)
    loop_wall_ms: Optional[float] = None
    memory_snapshots: Dict[str, Dict[str, float]] = field(default_factory=dict)
    _t0s: Dict[int, float] = field(default_factory=dict)
    _marks: Dict[int, tuple] = field(default_factory=dict)  # it -> (from, start, end) marks
    _last_mark: object = None  # where the next period starts
    _wall_from: object = None  # the mark the post-warmup loop wall starts at
    _started: int = 0
    _log_fh: object = None

    @property
    def _cuda(self) -> bool:
        return self.device.type == "cuda"

    def _mark(self):
        if self._cuda:
            ev = torch.cuda.Event(enable_timing=True)
            ev.record()
            return ev
        return time.perf_counter()

    def start(self, iteration: int):
        if iteration == 0 and self._cuda:
            torch.cuda.reset_peak_memory_stats(self.device)
        self._t0s[iteration] = time.perf_counter()
        first = self._mark()
        since = self._last_mark or first
        self._marks[iteration] = (since, first, None)
        if iteration >= self.warmup:
            if self._wall_from is None:
                self._wall_from = since
            self._started += 1

    def dispatched(self, iteration: int) -> float:
        """Right after the step call returns: marks the step's end on the
        device timeline; returns the host's time in the call."""
        self._last_mark = self._mark()
        self._marks[iteration] = self._marks[iteration][:2] + (self._last_mark,)
        dt = (time.perf_counter() - self._t0s.pop(iteration)) * 1e3
        if iteration >= self.warmup:
            self.dispatch_ms.append(dt)
        return dt

    def end(self, iteration: int, n_samples: int = 0) -> float:
        """When the step is drained: waits for its end mark and records its
        period and device time; returns the period."""
        since, first, last = self._marks.pop(iteration)
        tb = time.perf_counter()
        if self._cuda:
            last.synchronize()
            dt, busy = since.elapsed_time(last), first.elapsed_time(last)
        else:
            dt, busy = (last - since) * 1e3, (last - first) * 1e3
        blocked = (time.perf_counter() - tb) * 1e3
        self.all_times_ms.append(dt)
        if iteration >= self.warmup:
            self.iter_times_ms.append(dt)
            self.device_times_ms.append(busy)
            self.samples.append(n_samples)
            self.host_blocked_ms.append(blocked)
        return dt

    @contextlib.contextmanager
    def boundary(self):
        """Work between steps that is not a train step (eval, checkpoint,
        rollback), entered with no step in flight: the next step's period
        starts where it ends."""
        try:
            yield
        finally:
            self._last_mark = self._mark()

    def loop_fence(self):
        """End of the run: wait for the device, record the post-warmup wall
        (from the end of the last warmup step, on the same timeline as the
        periods)."""
        end = self._mark()
        if self._wall_from is not None and self._started > 0:
            if self._cuda:
                end.synchronize()
                self.loop_wall_ms = self._wall_from.elapsed_time(end)
            else:
                self.loop_wall_ms = (end - self._wall_from) * 1e3

    def profile_memory(self, iteration: int, stage: str = "") -> Dict[str, float]:
        """A stage-tagged `device_memory_stats` snapshot (the reference's
        ``profile_memory``), kept for the summary."""
        key = "iter_%d_%s" % (iteration, stage or "snap")
        self.memory_snapshots[key] = device_memory_stats(self.device)
        return self.memory_snapshots[key]

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
            "device_step_ms": float(np.percentile(self.device_times_ms, 50)),
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
        if self.dispatch_ms:
            out["dispatch_ms"] = float(np.mean(self.dispatch_ms))
        if self.host_blocked_ms:
            out["host_blocked_ms"] = float(np.mean(self.host_blocked_ms))
        if self.loop_wall_ms is not None:
            out["loop_wall_ms"] = self.loop_wall_ms
            out["wall_ms_per_iter"] = self.loop_wall_ms / self._started
            if self.loop_wall_ms > 0:
                out["steps_per_s"] = self._started / (self.loop_wall_ms / 1e3)
        if self.memory_snapshots:
            out["memory_snapshots"] = dict(self.memory_snapshots)
        return out

    def log_iteration(self, iteration: int, metrics: Optional[dict] = None, print_fn=print):
        """One line per logged iteration: its time and scalar metrics."""
        if not self.all_times_ms:
            return
        extra = ""
        if metrics:
            extra = " " + " ".join("%s=%.4g" % (k, float(v)) for k, v in metrics.items())
        line = "iter %4d | %8.2f ms%s" % (iteration, self.all_times_ms[-1], extra)
        print_fn(line)
        if self.log_dir:
            if self._log_fh is None:
                os.makedirs(self.log_dir, exist_ok=True)
                self._log_fh = open(os.path.join(self.log_dir, "train_%s.log" % self.model_name),
                                    "a")
            self._log_fh.write(line + "\n")

    def close(self):
        """Close the iteration log (the train driver calls this on its way
        out); safe to call again."""
        if self._log_fh is not None:
            try:
                self._log_fh.close()
            finally:
                self._log_fh = None
