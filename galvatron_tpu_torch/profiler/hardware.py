"""Hardware profiler: timed collectives over ``torch.distributed``.

Port of ``galvatron_tpu/profiler/hardware.py`` (the reference's
nccl-tests-driven HardwareProfiler, galvatron/core/profiler/
hardware_profiler.py:11-500). One process per GPU (``torchrun
--nproc_per_node N``; NCCL on the card, gloo on the CPU); every rank runs
the same sequence of collectives and rank 0 writes the files. All groups
of one size run their collective at once, the steady-state pattern of
hybrid-parallel training and what the cost model's coefficients describe.

Groups: a "consecutive" group of size g is a contiguous run of ranks
(``[i*g, (i+1)*g)``), a non-consecutive one is strided (``{j, j+N/g,
...}``), the JAX package's minor and major mesh axes (``_group_mesh``).
Every group set is made once, with ``new_group`` on every rank in one order.

Timing: CUDA events around each call on the card (each call drained before
the next), wall time on the CPU; a rank's time is aggregated over its
iterations (``avg_or_min_or_first``) and the slowest rank's is kept.

Outputs (the JAX package's schemas and file handling, ``profile_all``):
- allreduce_bandwidth_<N>chips.json  {"allreduce_size_%d_consec_%d": GB/s busbw}
- p2p_bandwidth_<N>chips.json        {"pp_size_%d": GB/s}
- sp_time_<N>chips.json              {"allreduce"|"all2all": {deg: {"popt": [ms/MB, ms]}}}
- overlap_coefficient.json           {"overlap_coe": t_both / max(t_gemm, t_allreduce)}
- dcn_bandwidth_<N>chips.json        across hosts: one host has none, so {}
An empty table writes no file and removes a stale one. On one device
there is no group of two: no all-reduce or p2p file, empty sp tables, and
``overlap_coe`` 1.0, as in the JAX package. ``quant_overhead_coe`` is left
out of the overlap file, so the search's parser keeps its default: the
quantized collectives it prices are ROADMAP queue 1 item 10.

Bus bandwidths follow nccl-tests: allreduce 2(g-1)/g * bytes/t; allgather,
reducescatter and all2all (g-1)/g * bytes/t; p2p ring sendrecv bytes/t.
"""

from __future__ import annotations

import os
import time
from dataclasses import dataclass
from typing import Callable, Dict, List, Optional, Tuple

import numpy as np
import torch
import torch.distributed as dist

from galvatron_tpu_torch.runtime import distributed
from galvatron_tpu_torch.utils.jsonio import write_json_config


@dataclass
class HardwareProfileArgs:
    """The JAX package's HardwareProfileArgs (reference
    galvatron_profile_hardware_args, core/profiler/arguments.py:88-180)."""

    start_mb: float = 1.0
    end_mb: float = 64.0
    scale: int = 2  # multiplicative step between message sizes
    warmup: int = 2
    iters: int = 5
    avg_or_min_or_first: str = "avg"
    max_pp_deg: int = 8
    max_tp_deg: int = 8
    overlap_time_multiply: int = 4
    config_dir: str = "configs"


def _aggregate(ts: List[float], mode: str) -> float:
    if mode == "min":
        return float(np.min(ts))
    if mode == "first":
        return float(ts[0])
    return float(np.mean(ts))


class HardwareProfiler:
    """Measures collective performance over the default process group
    (which the caller has initialized on `device`; the card unless the
    caller passes the CPU)."""

    def __init__(self, args: Optional[HardwareProfileArgs] = None,
                 device: Optional[torch.device] = None):
        if not dist.is_initialized():
            raise RuntimeError("HardwareProfiler needs the default process group "
                               "(runtime.distributed.process_group)")
        self.args = args or HardwareProfileArgs()
        self.device = (torch.device(device) if device is not None
                       else distributed.local_device("cuda"))
        self.rank = dist.get_rank()
        self.ndev = dist.get_world_size()
        self._groups: Dict[Tuple[int, bool], Tuple[object, List[int]]] = {}

    # ------------------------------------------------------------------ groups
    def group_ranks(self, group_size: int, consec: bool) -> List[List[int]]:
        """Every group of `group_size` ranks: contiguous runs when `consec`,
        else strided."""
        outer = self.ndev // group_size
        if consec:
            return [list(range(i * group_size, (i + 1) * group_size)) for i in range(outer)]
        return [list(range(j, self.ndev, outer)) for j in range(outer)]

    def _group(self, group_size: int, consec: bool):
        """(process group, ranks) of this rank's `group_size` group."""
        key = (group_size, consec)
        if key not in self._groups:
            if group_size > self.ndev:
                raise ValueError("group size %d > %d devices" % (group_size, self.ndev))
            backend = distributed.backend_for(self.device)
            for ranks in self.group_ranks(group_size, consec):
                g = distributed.subgroup(ranks, backend)  # every rank, every group
                if self.rank in ranks:
                    self._groups[key] = (g, ranks)
        return self._groups[key]

    def message(self, mb: float) -> torch.Tensor:
        """This rank's `mb` MB fp32 buffer, distinct per rank."""
        nelem = max(int(mb * 2**20) // 4, 8)
        return (torch.arange(nelem, dtype=torch.float32, device=self.device) * 1e-9
                + float(self.rank))

    # ------------------------------------------------------------- collectives
    def collective(self, kind: str, group_size: int, consec: bool,
                   x: torch.Tensor) -> Callable[[], torch.Tensor]:
        """A call that runs one `kind` collective of `x` over this rank's
        group and returns its result."""
        g, ranks = self._group(group_size, consec)
        n = x.numel()
        if kind == "allreduce":
            y = x.clone()  # reduced in place: the first call's result is the sum

            def run():
                dist.all_reduce(y, group=g)
                return y
        elif kind == "allgather":
            out = torch.empty(group_size * n, dtype=x.dtype, device=x.device)

            def run():
                dist.all_gather_into_tensor(out, x, group=g)
                return out
        elif kind == "reducescatter":
            out = torch.empty(n // group_size, dtype=x.dtype, device=x.device)
            src = x[: out.numel() * group_size]

            def run():
                dist.reduce_scatter_tensor(out, src, group=g)
                return out
        elif kind == "all2all":
            src = x[: n // group_size * group_size]
            out = torch.empty_like(src)

            def run():
                dist.all_to_all_single(out, src, group=g)
                return out
        elif kind == "sendrecv":
            me = ranks.index(self.rank)
            out = torch.empty_like(x)
            ops = [dist.P2POp(dist.isend, x, ranks[(me + 1) % group_size], g),
                   dist.P2POp(dist.irecv, out, ranks[(me - 1) % group_size], g)]

            def run():
                for req in dist.batch_isend_irecv(ops):
                    req.wait()
                return out
        else:
            raise ValueError(kind)
        return run

    def _time_ms(self, fn: Callable[[], object]) -> float:
        """`fn`'s time in ms, aggregated over the iterations, the slowest
        rank's."""
        a = self.args
        for _ in range(a.warmup):
            fn()
        cuda = self.device.type == "cuda"
        if cuda:
            torch.cuda.synchronize(self.device)
        ts = []
        for _ in range(a.iters):
            if cuda:
                start = torch.cuda.Event(enable_timing=True)
                end = torch.cuda.Event(enable_timing=True)
                start.record()
                fn()
                end.record()
                end.synchronize()
                ts.append(start.elapsed_time(end))
            else:
                t0 = time.perf_counter()
                fn()
                ts.append((time.perf_counter() - t0) * 1e3)
        local = torch.tensor([_aggregate(ts, a.avg_or_min_or_first)], dtype=torch.float64,
                             device=self.device)
        dist.all_reduce(local, op=dist.ReduceOp.MAX)
        return float(local.item())

    def _collective_time_ms(self, kind: str, group_size: int, consec: bool, mb: float) -> float:
        return self._time_ms(self.collective(kind, group_size, consec, self.message(mb)))

    @staticmethod
    def busbw_gbps(kind: str, group_size: int, mb: float, ms: float) -> float:
        """nccl-tests bus-bandwidth conventions."""
        g = group_size
        factor = {
            "allreduce": 2.0 * (g - 1) / g,
            "allgather": (g - 1) / g,
            "reducescatter": (g - 1) / g,
            "all2all": (g - 1) / g,
            "sendrecv": 1.0,
        }[kind]
        gb = mb / 1024.0
        return factor * gb / (ms / 1e3) if ms > 0 else float("inf")

    # ---------------------------------------------------------------- profiles
    def _group_sizes(self, limit: int) -> List[int]:
        out, g = [], 2
        while g <= min(limit, self.ndev):
            out.append(g)
            g *= 2
        return out

    def _sweep_mbs(self) -> List[float]:
        a, out = self.args, []
        mb = a.start_mb
        while mb <= a.end_mb:
            out.append(mb)
            mb *= a.scale
        return out

    def profile_allreduce_bandwidth(self) -> Dict[str, float]:
        """Bus bandwidth per (group size, consec) at the largest message."""
        mb = self.args.end_mb
        out: Dict[str, float] = {}
        for g in self._group_sizes(self.args.max_tp_deg * self.args.max_pp_deg):
            placements = [True] if g == self.ndev else [True, False]
            for consec in placements:
                ms = self._collective_time_ms("allreduce", g, consec, mb)
                out["allreduce_size_%d_consec_%d" % (g, int(consec))] = round(
                    self.busbw_gbps("allreduce", g, mb, ms), 3
                )
        return out

    def profile_p2p_bandwidth(self) -> Dict[str, float]:
        """Ring send/recv bandwidth per pipeline degree (stages strided, as
        the JAX package places them on the major axis)."""
        mb = self.args.end_mb
        out: Dict[str, float] = {}
        for g in self._group_sizes(self.args.max_pp_deg):
            ms = self._collective_time_ms("sendrecv", g, False, mb)
            out["pp_size_%d" % g] = round(self.busbw_gbps("sendrecv", g, mb, ms), 3)
        return out

    def profile_sp_time(self) -> Dict[str, Dict]:
        """Per-degree linear fits time(ms) = m * message_MB + c for allreduce
        and all2all over consecutive groups (the Ulysses and SP tables)."""
        fits: Dict[str, Dict] = {"allreduce": {}, "all2all": {}}
        mbs = self._sweep_mbs()
        for kind in ("allreduce", "all2all"):
            for g in self._group_sizes(self.args.max_tp_deg):
                times = [self._collective_time_ms(kind, g, True, mb) for mb in mbs]
                if len(mbs) < 2:
                    m, c = times[0] / mbs[0], 0.0
                else:
                    m, c = np.polyfit(np.asarray(mbs, np.float64), np.asarray(times, np.float64), 1)
                fits[kind][g] = {"popt": [float(max(m, 0.0)), float(max(c, 0.0))]}
        return fits

    def profile_dcn_bandwidth(self) -> Dict[str, float]:
        """Cross-host bandwidth: the port runs on one host, so none."""
        return {}

    def profile_overlap(self) -> Dict[str, float]:
        """Compute/communication overlap slowdown: a chain of 8k square GEMMs
        (bf16 on the card, fp32 on the CPU) on the current stream against a
        chain of k all-reduces over the whole world issued asynchronously
        (NCCL runs them on its own stream; gloo on its own thread);
        coe = t_both / max(t_gemm, t_allreduce), clamped to [1, 2]."""
        if self.ndev < 2:
            return {"overlap_coe": 1.0}
        a = self.args
        k = a.overlap_time_multiply
        n = 1024
        dtype = torch.bfloat16 if self.device.type == "cuda" else torch.float32
        w = torch.eye(n, dtype=dtype, device=self.device) * 1.0001
        x = self.message(a.end_mb)
        g, _ = self._group(self.ndev, True)

        def compute():
            y = w
            for _ in range(8 * k):
                y = y @ w
            return y

        def issue_comm():
            return [dist.all_reduce(x, group=g, async_op=True) for _ in range(k)]

        def comm():
            for h in issue_comm():
                h.wait()

        def both():
            handles = issue_comm()
            y = compute()
            for h in handles:
                h.wait()
            return y

        t_comp = self._time_ms(compute)
        t_comm = self._time_ms(comm)
        t_both = self._time_ms(both)
        coe = t_both / max(max(t_comp, t_comm), 1e-9)
        return {"overlap_coe": round(float(np.clip(coe, 1.0, 2.0)), 4)}

    # ------------------------------------------------------------------- files
    def config_paths(self) -> Dict[str, str]:
        d = self.args.config_dir
        tag = "%dchips" % self.ndev
        return {
            "allreduce": os.path.join(d, "allreduce_bandwidth_%s.json" % tag),
            "p2p": os.path.join(d, "p2p_bandwidth_%s.json" % tag),
            "sp": os.path.join(d, "sp_time_%s.json" % tag),
            "overlap": os.path.join(d, "overlap_coefficient.json"),
            "dcn": os.path.join(d, "dcn_bandwidth_%s.json" % tag),
        }

    def profile_all(self, write: bool = True) -> Dict[str, Dict]:
        """Bandwidths -> sp tables -> overlap (reference profile_hardware.py:
        5-16); rank 0 writes the files."""
        results = {
            "allreduce": self.profile_allreduce_bandwidth(),
            "p2p": self.profile_p2p_bandwidth(),
            "sp": self.profile_sp_time(),
            "overlap": self.profile_overlap(),
            "dcn": self.profile_dcn_bandwidth(),
        }
        if write and self.rank == 0:
            paths = self.config_paths()
            os.makedirs(self.args.config_dir, exist_ok=True)
            for key, data in results.items():
                if data:
                    write_json_config(data, paths[key])
                elif os.path.exists(paths[key]):
                    # an empty profile must not leave a stale file from a
                    # previous topology behind
                    os.remove(paths[key])
        if write:
            dist.barrier()
        return results
