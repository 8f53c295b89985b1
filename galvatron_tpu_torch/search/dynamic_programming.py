"""DP algorithm: per-stage knapsack over (layer, memory, strategy).

Port of ``galvatron_tpu/search/dynamic_programming.py`` (itself a
re-implementation of the reference's DPAlg/DpOnModel,
galvatron/core/search_engine/dynamic_programming.py:7-126, :128-513). The
cost tables, tie-breaks and backtracking are the JAX package's, line for
line, so both searches pick the same strategies.

The native core is the port's own copy of the DP core
(``galvatron_tpu_torch/csrc/dp_core.cpp``), built with g++ at first use into
``build/galvatron_tpu_torch/`` under a key of its source and flags, as the
index helper of ``data/dataset.py`` is. A failed build raises: the plain
numpy DP (``DPAlg._fit_numpy``) runs only when a caller asks for it with
``use_cpp_core=False``.
"""

from __future__ import annotations

import ctypes
import os
import threading
from typing import Dict, List, Optional

import numpy as np

from galvatron_tpu_torch.search.cost_model import comm_coe
from galvatron_tpu_torch.utils import native

SOURCE = os.path.join(os.path.dirname(os.path.dirname(os.path.abspath(__file__))),
                      "csrc", "dp_core.cpp")
CXX_FLAGS = ("-O2", "-fPIC", "-shared", "-std=c++17")
_lib = None
_lib_lock = threading.Lock()


def library_path() -> str:
    """Where the build of the DP core goes: keyed by its source and flags."""
    return native.keyed_path(SOURCE, "dp_core", CXX_FLAGS)


def build() -> str:
    """Compile the DP core if it has no build yet; returns the library
    path. Raises RuntimeError when the compiler ($CXX, default g++) is
    missing or fails."""
    return native.compile_shared(SOURCE, library_path(), CXX_FLAGS)


def _load_core():
    """The native DP core, built at first use (raises if it cannot be)."""
    global _lib
    with _lib_lock:
        if _lib is not None:
            return _lib
        lib = ctypes.CDLL(build())
        lib.dp_sweep.restype = ctypes.c_int
        lib.dp_sweep.argtypes = [
            ctypes.c_int, ctypes.c_int, ctypes.c_int,
            ctypes.POINTER(ctypes.c_int32), ctypes.POINTER(ctypes.c_int32),
            ctypes.POINTER(ctypes.c_double), ctypes.POINTER(ctypes.c_double),
            ctypes.POINTER(ctypes.c_double),
        ]
        lib.dp_backtrack.restype = ctypes.c_double
        lib.dp_backtrack.argtypes = [
            ctypes.c_int, ctypes.c_int, ctypes.c_int,
            ctypes.POINTER(ctypes.c_int32), ctypes.POINTER(ctypes.c_int32),
            ctypes.POINTER(ctypes.c_double), ctypes.c_int,
            ctypes.POINTER(ctypes.c_int32), ctypes.POINTER(ctypes.c_int),
        ]
        _lib = lib
        return _lib


def _ptr(a, ctype):
    return a.ctypes.data_as(ctypes.POINTER(ctype))


class DPAlg:
    """Single-stage DP (reference dynamic_programming.py:7-126). Memory is
    discretised to integer MB; `other_mem_cost`/`other_time_cost` map each
    candidate vocab-tp to the embed/cls stage cost added on top."""

    def __init__(
        self,
        max_mem: int = 8200,
        other_mem_cost: Dict[int, int] = None,
        other_time_cost: Dict[int, float] = None,
        layer_num: int = 24,
        strategy_num: int = 4,
        strategy_set=None,
        fine_grained_mode: bool = True,
        use_cpp_core: bool = True,
    ):
        assert other_mem_cost is not None
        self.max_mem = int(max_mem) + 1
        self.layer_num = layer_num
        self.strategy_num = strategy_num
        self.other_mem_cost = {k: int(v) for k, v in other_mem_cost.items()}
        self.other_time_cost = other_time_cost or {k: 0.0 for k in other_mem_cost}
        self.strategy_set = strategy_set
        self.fine_grained_mode = fine_grained_mode
        self.use_cpp_core = use_cpp_core
        if use_cpp_core:
            _load_core()  # build now: a broken toolchain raises here
        self.v_data = None
        self.inter_cost = None
        self.intra_cost = None

    def set_v_and_cost(self, v: np.ndarray, intra_layer_cost: np.ndarray, inter_layer_cost: np.ndarray):
        assert v.shape == (self.layer_num, self.strategy_num)
        assert intra_layer_cost.shape == (self.layer_num, self.strategy_num)
        assert inter_layer_cost.shape == (self.layer_num, self.strategy_num, self.strategy_num)
        self.v_data = np.ascontiguousarray(v, dtype=np.int32)
        self.intra_cost = np.ascontiguousarray(intra_layer_cost, dtype=np.float64)
        self.inter_cost = np.ascontiguousarray(inter_layer_cost, dtype=np.float64)

    # ------------------------------------------------------------------ modes
    def _fit_coarse(self):
        """Single global strategy (fine_grained_mode=False, reference
        dynamic_programming.py:62-75)."""
        res_list = {k: None for k in self.other_mem_cost}
        total_cost = {k: np.inf for k in self.other_mem_cost}
        remaining = {k: -1 for k in self.other_mem_cost}
        for k in self.other_mem_cost:
            for i in range(self.strategy_num):
                if self.strategy_set is not None and self.strategy_set[i][1] != k:
                    continue
                time_cost = (
                    float(np.sum(self.intra_cost[:, i]))
                    + float(np.sum(self.inter_cost[1:, i, i]))
                    + self.other_time_cost[k]
                )
                mem_cost = int(np.sum(self.v_data[:, i])) + self.other_mem_cost[k]
                if self.max_mem - 1 - mem_cost >= 0 and total_cost[k] > time_cost:
                    total_cost[k] = time_cost
                    remaining[k] = self.max_mem - 1 - mem_cost
                    res_list[k] = [i] * self.layer_num
        return total_cost, res_list, remaining

    def fit(self):
        if not self.fine_grained_mode:
            return self._fit_coarse()
        if self.use_cpp_core:
            return self._fit_cpp()
        return self._fit_numpy()

    def _fit_cpp(self):
        lib = _load_core()
        L, M, S = self.layer_num, self.max_mem, self.strategy_num
        mark = np.full((L, M, S), -1, dtype=np.int32)
        f = np.zeros((M, S), dtype=np.float64)
        lib.dp_sweep(
            L, M, S,
            _ptr(self.v_data, ctypes.c_int32), _ptr(mark, ctypes.c_int32),
            _ptr(f, ctypes.c_double), _ptr(self.inter_cost, ctypes.c_double),
            _ptr(self.intra_cost, ctypes.c_double),
        )
        total_cost, res_list, remaining = {}, {}, {}
        for vtp, om in self.other_mem_cost.items():
            res = np.full((L,), -1, dtype=np.int32)
            rem = ctypes.c_int(-1)
            cost = lib.dp_backtrack(
                L, M, S,
                _ptr(self.v_data, ctypes.c_int32), _ptr(mark, ctypes.c_int32),
                _ptr(f, ctypes.c_double), int(om),
                _ptr(res, ctypes.c_int32), ctypes.byref(rem),
            )
            if np.isinf(cost):
                total_cost[vtp], res_list[vtp], remaining[vtp] = np.inf, None, -1
            else:
                total_cost[vtp] = cost + self.other_time_cost[vtp]
                res_list[vtp] = [int(x) for x in res]
                remaining[vtp] = int(rem.value)
        return total_cost, res_list, remaining

    def _fit_numpy(self):
        """Plain numpy DP (the core's reference): loops layers x
        strategies; the memory axis is a numpy shift."""
        L, M, S = self.layer_num, self.max_mem, self.strategy_num
        INF = np.inf
        f = np.zeros((M, S), dtype=np.float64)
        mark = np.full((L, M, S), -1, dtype=np.int32)
        for i in range(L):
            f_new = np.full((M, S), INF)
            for s in range(S):
                need = int(self.v_data[i, s])
                if need >= M:
                    continue
                # candidate costs for all v >= need at once
                prev = f[: M - need, :]  # f[v-need, si]
                cand = prev + self.inter_cost[i, :, s][None, :]
                best_si = np.argmin(cand, axis=1)
                best = cand[np.arange(cand.shape[0]), best_si] + self.intra_cost[i, s]
                f_new[need:, s] = best
                mark[i, need:, s] = best_si
            f = f_new
        total_cost, res_list, remaining = {}, {}, {}
        for vtp, om in self.other_mem_cost.items():
            budget = M - 1 - int(om)
            if budget < 0 or not np.isfinite(f[budget].min()):
                total_cost[vtp], res_list[vtp], remaining[vtp] = np.inf, None, -1
                continue
            nxt = int(np.argmin(f[budget]))
            total_cost[vtp] = float(f[budget, nxt]) + self.other_time_cost[vtp]
            res = [-1] * L
            res[L - 1] = nxt
            v = budget
            for i in range(L - 1, 0, -1):
                cur = nxt
                nxt = int(mark[i, v, nxt])
                v -= int(self.v_data[i, cur])
                res[i - 1] = nxt
            res_list[vtp] = res
            remaining[vtp] = v - int(self.v_data[0, res[0]])
        return total_cost, res_list, remaining


class DpOnModel:
    """Per-pp-deg DP over the whole model (reference
    dynamic_programming.py:128-513): builds per-layer memory vectors,
    intra-layer time costs, inter-layer transition (resharding) costs; runs
    DPAlg per pipeline stage; picks the vocab-tp minimising total cost."""

    def __init__(
        self,
        strategies_set,
        memory_cost_model,
        time_cost_model,
        other_time_cost_model,
        model_args_list,
        train_args_list,
        parallel_args_list,
        profile_model_args_list,
        profile_hardware_args_list,
        max_mem: int = 8192,
        layer_nums: List[int] = (24,),
        multi_layer_type: bool = False,
        pp_stage_dict: Optional[Dict[int, List[int]]] = None,
        comm_coe_dict: Optional[Dict[str, float]] = None,
        gpu_num: int = 8,
        mem_cache_mb: int = 0,
        fine_grained_mode: bool = True,
        use_cpp_core: bool = True,
        use_pipeline_costmodel: bool = False,
        sequence_len: List[int] = (2048,),
        logger=None,
    ):
        self.strategies_set = strategies_set
        self.memory_cost_model = memory_cost_model
        self.time_cost_model = time_cost_model
        self.other_time_cost_model = other_time_cost_model
        self.model_args_list = model_args_list
        self.train_args_list = train_args_list
        self.parallel_args_list = parallel_args_list
        self.profile_model_args_list = profile_model_args_list
        self.profile_hardware_args_list = profile_hardware_args_list
        self.max_mem = max_mem
        self.layer_nums = list(layer_nums)
        self.total_layer_num = sum(self.layer_nums)
        self.pp_stage_dict = pp_stage_dict or {}
        self.comm_coe_dict = comm_coe_dict or {}
        self.gpu_num = gpu_num
        # inter-layer resharding coefficient: measured allreduce ms/MB at the
        # widest profiled group (comm_coe handles the 'N'/'N_0'/'N_1' key
        # styles); 0.01 only when no hardware profile was supplied at all
        self._reshard_coe = 0.01
        from galvatron_tpu_torch.search.cost_model import comm_coe

        for deg in [gpu_num] + [2**k for k in range(10, 0, -1)]:
            try:
                self._reshard_coe = comm_coe(self.comm_coe_dict, deg, consec=True)
                break
            except KeyError:
                continue
        self.mem_cache_mb = mem_cache_mb
        self.fine_grained_mode = fine_grained_mode
        self.use_cpp_core = use_cpp_core
        self.use_pipeline_costmodel = use_pipeline_costmodel
        self.sequence_len = list(sequence_len)
        self.sequence_parallel = bool(
            getattr(self.parallel_args_list[0], "sequence_parallel", True)
            if self.parallel_args_list else True
        )
        self.logger = logger

    # ------------------------------------------------------------ cost pieces
    @staticmethod
    def _match_except(si, sj, keys) -> bool:
        """True when the two strategies differ at most in `keys` of the info
        dict (reference DpOnModel.match_strategy)."""
        if si[:3] != sj[:3]:
            return False
        a = dict(si[3]) if len(si) > 3 else {}
        b = dict(sj[3]) if len(sj) > 3 else {}
        for k in keys:
            a.pop(k, None)
            b.pop(k, None)
        return a == b

    def _inter_layer_cost(self, strategies, layer_type: int, mbsz: float,
                          min_tp: int = 1) -> np.ndarray:
        """Per-(prev, cur) transition cost: the activation RESHARDING volume
        between two layers' shardings times the measured allreduce
        coefficient for the group the collective rides (re-derivation of the
        reference's worked case table, dynamic_programming.py:290-372; on TPU
        the collective is the with_sharding_constraint boundary op).

        A boundary collective is needed when the current layer must re-gather
        activations the previous layer left sharded differently:
          - the tp degree grows (hidden shards widen: all-gather),
          - equal tp but different tp_consecutive (shards move between
            minor/major mesh axes),
          - megatron-sp activations with ANY tp change (seq shards re-split),
          - the cp degree changes (seq shards re-split over the cp axes).
        Volume: each device then touches its (1/min_tp-normalised) microbatch
        share of seq x hidden at (max of the two degrees)-way sharding:
        (d-1)/d x mbsz x (d / min_tp) x seq x hidden x bytes."""
        S = len(strategies)
        ma = self.model_args_list[layer_type]
        ta = self.train_args_list[layer_type]
        bytes_per = 2 if ta.mixed_precision else 4
        sample_mb = ma.seq_length * ma.hidden_size * bytes_per / 1024 / 1024
        cost = np.zeros((S, S))

        def info(s):
            return s[3] if len(s) > 3 else {}

        for i, si in enumerate(strategies):  # previous layer
            for j, sj in enumerate(strategies):  # current layer
                ii, ij = info(si), info(sj)
                tp_i, tp_j = si[1], sj[1]
                grow_tp = tp_j > tp_i
                consec_flip = (
                    tp_j == tp_i and ii.get("tp", 1) != ij.get("tp", 1)
                )
                sp_retile = bool(self.sequence_parallel) and tp_j != tp_i
                cp_change = ii.get("cp", 1) != ij.get("cp", 1)
                if not (grow_tp or consec_flip or sp_retile or cp_change):
                    continue
                d = max(tp_i, tp_j, ii.get("cp", 1), ij.get("cp", 1))
                vol = (d - 1) / d * mbsz * (d // max(min_tp, 1)) * sample_mb
                # coefficient for the group the collective rides: the larger
                # tp side's consecutivity decides minor vs major axes
                big = sj if tp_j >= tp_i else si
                consec = bool(info(big).get("tp", 1))
                coe_deg = max(d, 2)
                try:
                    coe = comm_coe(self.comm_coe_dict, coe_deg, consec=consec)
                except KeyError:
                    coe = self._reshard_coe
                cost[i, j] = vol * coe
        # ordered tie-break biases so equivalent variants sort
        # deterministically: prefer entering sp, then fsdp, then ckpt
        # (reference dynamic_programming.py:347-371)
        for i, si in enumerate(strategies):
            for j, sj in enumerate(strategies):
                if i == j:
                    continue
                ij = info(sj)
                if self._match_except(si, sj, ["sp"]) and ij.get("sp", 0):
                    cost[i, j] = 1e-10
                # comm-precision twins share a layout: zero resharding, tiny
                # ordered bias so equal-cost runs settle deterministically
                # on the quantized variant
                if self._match_except(si, sj, ["gcd", "pcd"]) and (
                    ij.get("gcd", "none") != "none"
                    or ij.get("pcd", "none") != "none"
                ):
                    cost[i, j] = 5e-10
                if self._match_except(si, sj, ["fsdp"]) and ij.get("fsdp", 0):
                    cost[i, j] = 1e-9
                if self._match_except(si, sj, ["cpt"]) and ij.get("cpt", 0):
                    cost[i, j] = 2e-9
                # remat-policy twins (same layout + cpt, different rp): zero
                # resharding; bias toward the lighter-recompute policy so
                # equal-cost runs settle deterministically
                if (
                    self._match_except(si, sj, ["rp"])
                    and ij.get("rp", "full") != "full"
                    and ij.get("cpt", 0)
                ):
                    cost[i, j] = 15e-10
                if (
                    self._match_except(si, sj, ["fsdp", "cpt"])
                    and not self._match_except(si, sj, ["fsdp"])
                    and not self._match_except(si, sj, ["cpt"])
                    and ij.get("fsdp", 0) and ij.get("cpt", 0)
                ):
                    cost[i, j] = 3e-9
        return cost

    def _build_stage_dp(self, pp_deg: int, bsz: float, mbsz: float, min_tp: int, max_tp: int,
                        vsp: int, embed_sdp: bool, chunks: int):
        """Returns (total_cost, per-layer strategy indices, remaining mem,
        best vtp) for one pp degree."""
        strategies = [s for s in self.strategies_set if s[0] == pp_deg]
        if not strategies:
            return np.inf, None, -1, -1
        S = len(strategies)
        partition = self.pp_stage_dict.get(
            pp_deg,
            [self.total_layer_num // pp_deg] * (pp_deg - 1)
            + [self.total_layer_num - self.total_layer_num // pp_deg * (pp_deg - 1)],
        )
        layer_type_of = []
        for t, n in enumerate(self.layer_nums):
            layer_type_of += [t] * n

        # per (layer_type, strategy): memory + time
        mem_cost: List[List[Dict]] = []
        intra_time = np.zeros((len(self.layer_nums), S))
        for t in range(len(self.layer_nums)):
            row = []
            for si, strat in enumerate(strategies):
                mcm = self.memory_cost_model(
                    strat, bsz, mbsz=int(max(mbsz, 1)), min_tp=min_tp, max_tp=max_tp,
                    stage_idx=0, vsp=vsp, embed_sdp=embed_sdp,
                    model_args=self.model_args_list[t], train_args=self.train_args_list[t],
                    parallel_args=self.parallel_args_list[t],
                    profile_model_args=self.profile_model_args_list[t],
                ).get_memory_cost()
                row.append(mcm)
                # full-iteration per-layer time: compute/tp-comm scale with the
                # whole local batch; the grad allreduce volume is paid ONCE per
                # iteration regardless of chunks (fix vs per-microbatch x chunks,
                # which overcounts batch-size-independent costs)
                intra_time[t, si] = self.time_cost_model(
                    strat, bsz,
                    model_args=self.model_args_list[t], train_args=self.train_args_list[t],
                    parallel_args=self.parallel_args_list[t],
                    profile_model_args=self.profile_model_args_list[t],
                    profile_hardware_args=self.profile_hardware_args_list[t],
                ).gen_result()
            mem_cost.append(row)

        # other (embed/cls) costs per vtp, from the FIRST layer type's model
        other_mem_all = mem_cost[0][0]["other"]  # {vtp: [per-stage MB]}
        otc = self.other_time_cost_model(
            mbsz=int(max(mbsz, 1)), pp_deg=pp_deg, world_size=self.gpu_num, vsp=vsp,
            embed_sdp=embed_sdp, min_tp=min_tp, max_tp=max_tp,
            sequence_length_list=self.sequence_len,
            model_args=self.model_args_list[0], train_args=self.train_args_list[0],
            parallel_args=self.parallel_args_list[0],
            profile_model_args=self.profile_model_args_list[0],
            profile_hardware_args=self.profile_hardware_args_list[0],
        ).gen_result()

        # DP per pipeline stage; each stage gets budget max_mem, own layers
        total_cost_by_vtp: Dict[int, float] = {}
        res_by_vtp: Dict[int, List[int]] = {}
        rem_by_vtp: Dict[int, int] = {}
        vtps = [v for v in other_mem_all.keys() if v in otc]
        if not vtps:
            return np.inf, None, -1, -1
        # inter-layer transition matrix depends only on (layer_type, bsz)
        inter_by_type = [
            self._inter_layer_cost(strategies, t, mbsz, min_tp)
            for t in range(len(self.layer_nums))
        ]
        start = 0
        for stage in range(pp_deg):
            n_stage = partition[stage]
            v = np.zeros((n_stage, S), dtype=np.int64)
            intra = np.zeros((n_stage, S))
            inter = np.zeros((n_stage, S, S))
            for li in range(n_stage):
                t = layer_type_of[start + li]
                for si in range(S):
                    v[li, si] = int(mem_cost[t][si]["enc_total"])
                    intra[li, si] = intra_time[t, si]
                if li > 0:
                    inter[li] = inter_by_type[layer_type_of[start + li]]
            other_mem_stage = {
                vtp: int(per_stage[stage] if stage < len(per_stage) else 0)
                for vtp, per_stage in other_mem_all.items()
                if vtp in otc
            }
            # uneven division: the stacked layout stores max(partition) slots
            # on EVERY stage — short stages hold zero-padded params +
            # optimizer state for the missing slots (pipeline.stack_params).
            # Charge it conservatively (max over strategies) so a config
            # that passes the search cannot OOM on its short stages.
            pad_slots = max(partition) - n_stage
            if pad_slots > 0:
                t_pad = layer_type_of[start]
                pad_mb = pad_slots * max(
                    int(mem_cost[t_pad][si]["model_states"]) for si in range(S)
                )
                other_mem_stage = {
                    vtp: m + pad_mb for vtp, m in other_mem_stage.items()
                }
            other_time_stage = {
                vtp: (otc[vtp][stage] if stage < len(otc[vtp]) else 0.0) * chunks for vtp in other_mem_stage
            }
            alg = DPAlg(
                max_mem=self.max_mem - self.mem_cache_mb,
                other_mem_cost=other_mem_stage,
                other_time_cost=other_time_stage,
                layer_num=n_stage,
                strategy_num=S,
                strategy_set=strategies,
                fine_grained_mode=self.fine_grained_mode,
                use_cpp_core=self.use_cpp_core,
            )
            alg.set_v_and_cost(v, intra, inter)
            tc, res, rem = alg.fit()
            for vtp in list(vtps):
                if not np.isfinite(tc.get(vtp, np.inf)) or res.get(vtp) is None:
                    vtps.remove(vtp)
                    total_cost_by_vtp.pop(vtp, None)
                    continue
                total_cost_by_vtp[vtp] = total_cost_by_vtp.get(vtp, 0.0) + tc[vtp]
                res_by_vtp.setdefault(vtp, []).extend(res[vtp])
                rem_by_vtp[vtp] = min(rem_by_vtp.get(vtp, 1 << 30), rem[vtp])
            start += n_stage
        if not vtps:
            return np.inf, None, -1, -1
        best_vtp = min(vtps, key=lambda k: total_cost_by_vtp[k])
        res_strategies = [strategies[i] for i in res_by_vtp[best_vtp]]
        total = total_cost_by_vtp[best_vtp]
        if self.use_pipeline_costmodel and pp_deg > 1:
            # bubble-aware rescoring of the chosen strategy sequence
            # (reference dynamic_programming.py:430, cost_model.py:695-768)
            from galvatron_tpu_torch.search.cost_model import pipeline_costmodel

            total = pipeline_costmodel(
                self.time_cost_model,
                self.layer_nums,
                self.model_args_list,
                self.train_args_list,
                self.parallel_args_list,
                self.profile_model_args_list,
                self.profile_hardware_args_list,
                res_strategies,
                partition,
                chunks,
                bsz,
                min_tp,
                otc[best_vtp],
                logger=self.logger,
            )
        return total, res_strategies, rem_by_vtp[best_vtp], best_vtp

    def fit(self, bsz: float, mbsz: float = 1, min_tp: int = 1, max_tp: int = 8,
            vsp: int = 0, embed_sdp: bool = False, chunks: int = 1, pp_degs=None):
        """Iterate pp degrees (reference dynamic_programming.py:515-565)."""
        best = (np.inf, None, -1, -1, -1)  # cost, strategies, rem, vtp, pp
        pp_degs = pp_degs or sorted({s[0] for s in self.strategies_set})
        for pp_deg in pp_degs:
            cost, res, rem, vtp = self._build_stage_dp(
                pp_deg, bsz, mbsz, min_tp, max_tp, vsp, embed_sdp, chunks
            )
            if cost < best[0]:
                best = (cost, res, rem, vtp, pp_deg)
        return best
