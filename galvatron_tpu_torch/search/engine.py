"""Search engine.

Port of ``galvatron_tpu/search/engine.py`` (a re-design of the reference
`GalvatronSearchEngine`, galvatron/core/search_engine/search_engine.py:
24-1103): loads profiled model/hardware JSONs, generates the strategy
space, runs the DP per (bsz, chunks, min_tp, vsp, embed_sdp) combination,
and saves the winner as a runtime-loadable strategy JSON
(HybridParallelConfig schema). Every search axis is kept (sp_space,
context parallelism, remat policies, quantized grad sync with its budget,
the serve objective, uneven pipelines, several layer types), so for the
same profiles and flags the JSON equals the JAX package's; what the port's
trainer cannot run yet it refuses at train time
(``analysis/strategy_lint.train_refusals``). The winner's trace lint
(``trace_lint``) is refused: the trace linter is not ported (ROADMAP queue
1 item 12a, the collective audit of ``analysis/trace_lint.py``).

Pure CPU: no torch and no accelerator needed.
"""

from __future__ import annotations

import math
import os
from dataclasses import dataclass
from typing import Dict, List, Optional

import numpy as np

from galvatron_tpu_torch.config.strategy import HybridParallelConfig, LayerStrategy
from galvatron_tpu_torch.search.cost_model import (
    MemoryCostModel,
    OtherTimeCostModel,
    ServeTimeCostModel,
    TimeCostModel,
    serve_memory_mb,
)
from galvatron_tpu_torch.search.cost_model_args import (
    ModelArgs,
    ParallelArgs,
    ProfileHardwareArgs,
    ProfileModelArgs,
    TrainArgs,
)
from galvatron_tpu_torch.search.dynamic_programming import DpOnModel
from galvatron_tpu_torch.utils.strategy_utils import form_strategy


@dataclass
class SearchArgs:
    """Search flags (reference search_engine/arguments.py:1-146)."""

    memory_constraint: float = 16.0  # GB per chip HBM budget
    search_space: str = "full"  # full | dp+tp | dp+pp | 3d | dp | sdp | tp | pp
    sp_space: str = "tp"  # tp+sp | tp | sp
    disable_dp: bool = False
    disable_tp: bool = False
    disable_vtp: bool = False
    disable_pp: bool = False
    disable_sdp: bool = False
    disable_ckpt: bool = False
    disable_tp_consec: bool = False
    disable_cp: bool = True  # context parallel search (off by default, as ref)
    max_tp_deg: int = 8
    max_pp_deg: int = 8
    max_cp_deg: int = 4
    min_bsz: int = 8
    max_bsz: Optional[int] = None
    bsz_scale: int = 8
    settle_bsz: Optional[int] = None
    settle_chunk: Optional[int] = None
    fine_grained_mode: bool = True
    # tick-exact 1F1B pricing (cost_model.schedule_total_time) — on by
    # default since r4; the reference defaults its cruder variant off
    use_pipeline_costmodel: bool = True
    mixed_precision: bool = True
    default_dp_type: str = "ddp"
    embed_sdp: int = -1  # -1: search both; 0/1: fixed
    vsp: int = -1  # -1: search both; 0/1: fixed
    mem_cache_gb: float = 0.0
    costmodel_coe: float = 1.0
    parallel_search: bool = False  # thread-parallel outer loop (--parallel_search)
    log_dir: Optional[str] = None  # per-task search log files (reference
    # search_engine.py:379-382 get_thread_logger); None = no file logging
    # comm-precision axis (ROADMAP item 2): "off" keeps the classic space;
    # a wire dtype adds, for every pure-dp strategy, a variant whose grad
    # sync (and zero3 gather under fsdp) uses that payload — the per-layer
    # DP then picks precision layer by layer under the accuracy budget
    comm_quant: str = "off"  # off | bf16 | int8 | fp8_e4m3
    comm_quant_block: int = 64
    comm_quant_budget: float = 1.0  # max fraction of layers quantized
    # remat axis (ROADMAP item 1): adds, for every checkpointed strategy, a
    # 'dots_saveable' per-layer policy variant — the DP then mixes none /
    # dots_saveable / full layer by layer under the memory budget. The other
    # named policies degenerate to existing points ("none" == cpt=0,
    # "nothing_saveable" prices like "full"), so only dots is enumerated.
    remat_search: bool = False
    # latency-aware serving objective (ROADMAP item 4): "train" keeps the
    # classic throughput DP; "serve" prices prefill (compute-bound) and
    # decode (bandwidth-bound) separately over the decode-compatible subset
    # of the space and maximises decode tokens/s/chip under the p99 bounds
    objective: str = "train"  # train | serve
    # the JAX package's opt-in winner trace lint; kept for the dataclass's
    # parity and refused by save_results (ROADMAP queue 1 item 12a)
    trace_lint: bool = False
    p99_ttft_ms: float = 0.0  # p99 time-to-first-token bound, ms (0 = unbounded)
    p99_tpot_ms: float = 0.0  # p99 time-per-output-token bound, ms (0 = unbounded)
    serve_max_concurrency: int = 8  # decode slots the engine holds KV for
    serve_page_size: int = 16  # KV page granularity (contexts round up)
    serve_hbm_gbps: float = 100.0  # per-chip HBM read bandwidth (decode roofline)
    serve_kv_frac: float = 1.0  # num_kv_heads / num_heads (GQA KV shrink)


class _TaskLog:
    """Append-per-call file log: no logging-registry state to collide across
    engines with different log_dirs, no file descriptors held open (the
    outer loop can spawn hundreds of tasks)."""

    def __init__(self, path: str):
        self.path = path
        with open(path, "w"):
            pass

    def info(self, msg: str) -> None:
        with open(self.path, "a") as f:
            f.write(msg + "\n")


def get_task_logger(log_dir: str, model_name: str, bsz: int, chunks: int,
                    min_tp: int, max_tp: int, vsp: int, embed_sdp: bool) -> _TaskLog:
    """Per-task file log under ``log_dir`` (reference get_thread_logger,
    search_engine/utils.py:9-32: one file per outer-loop task so parallel
    searches stay separable)."""
    task_dir = os.path.join(log_dir, "search_bsz%d_chunk%d" % (bsz, chunks))
    os.makedirs(task_dir, exist_ok=True)
    return _TaskLog(os.path.join(
        task_dir,
        "min_tp%d_max_tp%d_vsp%d_embed_sdp%d.log" % (min_tp, max_tp, vsp, int(embed_sdp)),
    ))


def generate_strategies(world_size: int, args: SearchArgs) -> List[list]:
    """Enumerate [pp, tp, dp, info] strategies (reference
    search_engine.py:783-914). Degrees are powers of two."""

    def pow2s(limit):
        out, k = [], 1
        while k <= limit:
            out.append(k)
            k *= 2
        return out

    space = args.search_space
    strategies = []
    for pp in pow2s(min(args.max_pp_deg, world_size)):
        if args.disable_pp and pp > 1:
            continue
        if space in ("dp", "sdp", "tp", "dp+tp") and pp > 1:
            continue
        per_stage = world_size // pp
        if per_stage * pp != world_size:
            continue
        for tp in pow2s(min(args.max_tp_deg, per_stage)):
            if args.disable_tp and tp > 1:
                continue
            if space in ("dp", "sdp", "pp", "dp+pp") and tp > 1:
                continue
            cps = pow2s(min(args.max_cp_deg, per_stage // tp)) if not args.disable_cp else [1]
            for cp in cps:
                dp = per_stage // tp // cp
                if dp * tp * cp != per_stage:
                    continue
                if args.disable_dp and dp > 1:
                    continue
                if space in ("tp", "pp") and dp > 1:
                    continue
                base_infos: List[dict] = [{}]
                # tp consecutive placement choice (minor vs major ICI axes)
                if space == "3d":
                    # plain pp x tp x dp grid: no placement/sp/zero/ckpt variants
                    strategies.append([pp, tp, dp, {"tp": 1} if tp > 1 else {}])
                    continue
                if tp > 1 and dp > 1 and not args.disable_tp_consec:
                    base_infos = [{"tp": 1}, {"tp": 0}]
                elif tp > 1:
                    base_infos = [{"tp": 1}]
                # megatron-tp vs ulysses-sp per layer
                sp_flags = [0]
                if tp > 1 and args.sp_space == "tp+sp":
                    sp_flags = [0, 1]
                elif tp > 1 and args.sp_space == "sp":
                    sp_flags = [1]
                for info0 in base_infos:
                    for spf in sp_flags:
                        for fsdp in ([0] if (args.disable_sdp or space in ("dp", "tp", "pp")) else [0, 1]):
                            if space == "sdp" and not fsdp and dp > 1:
                                continue
                            for cpt in [0] if args.disable_ckpt else [0, 1]:
                                info = dict(info0)
                                if spf:
                                    info["sp"] = 1
                                    info.pop("tp", None)
                                if fsdp:
                                    info["fsdp"] = 1
                                if cpt:
                                    info["cpt"] = 1
                                if cp > 1:
                                    info["cp"] = cp
                                strategies.append([pp, tp, dp, info])
                                # remat-policy variant: a checkpointed layer
                                # that pins its dot outputs recomputes only
                                # the cheap tail — more memory than full
                                # remat, less backward time
                                if args.remat_search and cpt:
                                    rinfo = dict(info)
                                    rinfo["rp"] = "dots_saveable"
                                    strategies.append([pp, tp, dp, rinfo])
                                # comm-precision variant (ROADMAP item 2):
                                # only where the quantized ring can run —
                                # pure data parallel with a dp group to talk
                                # over (parallel/quant_collectives.py's
                                # support contract, mirrored by GLS013)
                                if (args.comm_quant != "off" and pp == 1
                                        and tp == 1 and cp == 1 and not spf
                                        and dp > 1):
                                    qinfo = dict(info)
                                    qinfo["gcd"] = args.comm_quant
                                    if fsdp:
                                        qinfo["pcd"] = args.comm_quant
                                    strategies.append([pp, tp, dp, qinfo])
    # dedupe
    seen, out = set(), []
    for s in strategies:
        key = (s[0], s[1], s[2], tuple(sorted(s[3].items())))
        if key not in seen:
            seen.add(key)
            out.append(s)
    return out


def pp_division_memory_balanced(
    memory_cost_list: List[float], pp_deg: int
) -> List[int]:
    """Split layers into pp_deg contiguous groups with balanced summed memory
    (reference search_engine.py:972-1088, greedy re-implementation)."""
    n = len(memory_cost_list)
    if pp_deg == 1:
        return [n]
    total = float(np.sum(memory_cost_list))
    target = total / pp_deg
    division, acc, count = [], 0.0, 0
    for i, m in enumerate(memory_cost_list):
        remaining_stages = pp_deg - len(division)
        remaining_layers = n - i
        if len(division) < pp_deg - 1 and (
            acc + m / 2 >= target or remaining_layers <= (remaining_stages - 1)
        ) and count > 0:
            division.append(count)
            acc, count = 0.0, 0
        acc += m
        count += 1
    division.append(count)
    while len(division) < pp_deg:
        # split the largest group
        j = int(np.argmax(division))
        if division[j] < 2:
            return [n // pp_deg] * (pp_deg - 1) + [n - n // pp_deg * (pp_deg - 1)]
        division[j] -= 1
        division.insert(j + 1, 1)
    return division


class GalvatronSearchEngine:
    """profile JSONs -> optimal layer-wise strategy JSON."""

    def __init__(
        self,
        args: SearchArgs,
        world_size: int,
        model_layer_configs: List[dict],
        # each: {"hidden_size", "seq_len", "layer_num"}
        config_dir: str = "configs",
        model_name: str = "model",
        logger=None,
        align_type_boundaries: bool = True,
        allow_sequence_sharding: bool = True,
    ):
        self.args = args
        self.world_size = world_size
        self.layer_configs = model_layer_configs
        self.num_layertype = len(model_layer_configs)
        self.config_dir = config_dir
        self.model_name = model_name
        self.logger = logger
        # multi-layer-type families whose pipeline engine accepts mid-stage
        # type boundaries (swin patch merges) set this False via the family's
        # mid_stage_type_boundaries flag; enc-dec keeps True (the
        # encoder/decoder boundary must land on a stage boundary)
        self.align_type_boundaries = align_type_boundaries
        # families without a shardable sequence dimension (swin, via the
        # supports_sequence_sharding family flag) get cp/ulysses-sp strategies
        # filtered at ANY pp degree — they are unrunnable, not misaligned
        self.allow_sequence_sharding = allow_sequence_sharding
        self.strategies: List[list] = []
        self.optimal_chunk_func = None

    # --------------------------------------------------------------- loading
    def set_model_profiles(self, time_config: dict, memory_config: dict):
        """Processed profiling tables, one entry per layer type.

        time_config:  {"layertype_%d": ms-per-layer-per-sample | [m,c] fit,
                       "other_time": ms | [m,c]}
        memory_config: {"layertype_%d": {"parameter_size": MB,
                        "tp_activation_per_bsz_dict": {tp: MB, 'checkpoint': MB}},
                        "other_memory_pp_off": {...}, "other_memory_pp_on": {...}}
        """
        self.time_config = time_config
        self.memory_config = memory_config

    def set_hardware_profiles(
        self,
        allreduce_bandwidth_config: dict,
        p2p_bandwidth_config: Optional[dict] = None,
        overlap_config: Optional[dict] = None,
        sp_time_config: Optional[dict] = None,
    ):
        """Hardware JSONs (schemas match the reference hardware profiler:
        allreduce_bandwidth_*.json keys 'allreduce_size_%d_consec_%d' in GB/s;
        p2p_bandwidth 'pp_size_%d'; overlap 'overlap_coe'). Parsing is shared
        with profiler/validate via parse_hardware_profiles."""
        from galvatron_tpu_torch.search.cost_model_args import parse_hardware_profiles

        hwp = parse_hardware_profiles(
            allreduce_bandwidth_config, p2p_bandwidth_config,
            overlap_config, sp_time_config,
        )
        self.comm_coe_dict = hwp["comm_coe_dict"]
        self.p2p_coe_dict = hwp["p2p_coe_dict"]
        self.overlap_coe = hwp["overlap_coe"]
        self.allreduce_dict = hwp["allreduce_dict"]
        self.all2all_dict = hwp["all2all_dict"]
        self.quant_overhead_coe = hwp.get("quant_overhead_coe", 0.02)

    # ------------------------------------------------------------- arg bundles
    def _bundles(self, chunks: Optional[int]):
        a = self.args
        ma_list, ta_list, pa_list, pma_list, pha_list = [], [], [], [], []
        for t, lc in enumerate(self.layer_configs):
            ma_list.append(
                ModelArgs(
                    parameter_size=self.memory_config["layertype_%d" % t]["parameter_size"],
                    seq_length=lc["seq_len"],
                    hidden_size=lc["hidden_size"],
                    layer_num=lc["layer_num"],
                )
            )
            ta_list.append(TrainArgs(mixed_precision=a.mixed_precision))
            pa_list.append(
                ParallelArgs(
                    use_zero2_for_dp=(a.default_dp_type == "zero2"),
                    max_tp_deg=a.max_tp_deg,
                    disable_vtp=a.disable_vtp,
                    sequence_parallel=True,
                    sp_space=a.sp_space,
                    chunks=chunks,
                    comm_quant_block=a.comm_quant_block,
                    # every emitted pp>1 config runs the 1F1B engine
                    # (save_results labels them pipedream_flush below), so the
                    # memory model must price the 1F1B watermark, not gpipe
                    pipeline_type="pipedream_flush",
                )
            )
            pma_list.append(
                ProfileModelArgs(
                    forward_computation_time=self.time_config["layertype_%d" % t],
                    tp_activation_per_bsz_dict=self.memory_config["layertype_%d" % t][
                        "tp_activation_per_bsz_dict"
                    ],
                    other_memory_pp_off=self.memory_config.get("other_memory_pp_off", {}),
                    other_memory_pp_on=self.memory_config.get("other_memory_pp_on", {}),
                    other_time_profiled=self.time_config.get("other_time", 1.0),
                    # measured per-policy recompute fractions (profiler's
                    # profile_remat output); None -> analytic table
                    remat_recompute_frac=self.time_config.get(
                        "remat_recompute_frac"),
                )
            )
            pha_list.append(
                ProfileHardwareArgs(
                    comm_coe_dict=self.comm_coe_dict,
                    dp_overlap_coe=self.overlap_coe,
                    bct_overlap_coe=self.overlap_coe,
                    p2p_comm_coe_dict=self.p2p_coe_dict,
                    allreduce_dict=self.allreduce_dict,
                    all2all_dict=self.all2all_dict,
                    costmodel_coe=self.args.costmodel_coe,
                    quant_overhead_coe=getattr(self, "quant_overhead_coe", 0.02),
                )
            )
        return ma_list, ta_list, pa_list, pma_list, pha_list

    # ------------------------------------------------------------------ search
    def initialize_search_engine(self):
        self.strategies = generate_strategies(self.world_size, self.args)
        return self.strategies

    def _pp_stage_dict(self, bundles) -> Dict[int, List[int]]:
        """Memory-balanced layer division per pp degree, using each layer's
        tp=1 zero-free memory as weight."""
        ma_list, ta_list, pa_list, pma_list, _ = bundles
        weights = []
        for t, lc in enumerate(self.layer_configs):
            m = MemoryCostModel(
                [1, 1, self.world_size, {}], global_batch_size=self.args.min_bsz,
                mbsz=1, min_tp=1, max_tp=self.args.max_tp_deg,
                model_args=ma_list[t], train_args=ta_list[t], parallel_args=pa_list[t],
                profile_model_args=pma_list[t],
            ).get_memory_cost()["enc_total"]
            weights += [m] * lc["layer_num"]
        out = {}
        for pp in sorted({s[0] for s in self.strategies}):
            n = len(weights)
            if self.num_layertype == 1:
                # the generic 1F1B engine accepts UNEVEN divisions (padded
                # trailing slots). One layer type => uniform weights, so the
                # memory-balanced split is exactly ceil/floor; ceil stages
                # first keeps the early stages (largest 1F1B in-flight
                # activation count) no fatter than max, and minimises the
                # padded-slot overhead (<= 1 layer per floor stage)
                if pp <= n:
                    r = n % pp
                    out[pp] = [n // pp + 1] * r + [n // pp] * (pp - r)
            else:
                # multi-layer-type engines (enc-dec / hierarchical) require
                # EQUAL stages with type boundaries on stage boundaries:
                # snap divisible layer counts to the uniform division;
                # non-divisible counts cannot run at this pp at all
                if n % pp == 0:
                    out[pp] = [n // pp] * pp
        return out

    def search_for_bsz_chunk(self, bsz: int, chunks: int, min_tp: int = 1,
                             max_tp: Optional[int] = None, vsp: int = 0,
                             embed_sdp: bool = False, sp_search: int = 3):
        """One DP task of the outer sweep. min_tp/max_tp bound the per-layer
        tp degrees considered (and min_tp floors the vocab-tp candidates);
        sp_search selects the sequence-parallel sub-space: 1 = tp-style only
        (sp flag 0), 2 = ulysses only (sp flag 1), 3 = both (reference outer
        loop, search_engine.py:339-537)."""
        max_tp = max_tp or self.args.max_tp_deg
        tlog = None
        if self.args.log_dir:
            tlog = get_task_logger(
                self.args.log_dir, self.model_name, bsz, chunks,
                min_tp, max_tp, vsp, embed_sdp,
            )
            tlog.info(
                "start: bsz=%d chunks=%d min_tp=%d max_tp=%d vsp=%d "
                "embed_sdp=%d sp_search=%d" % (
                    bsz, chunks, min_tp, max_tp, vsp, int(embed_sdp), sp_search
                )
            )
        bundles = self._bundles(chunks)
        ma_list, ta_list, pa_list, pma_list, pha_list = bundles
        # a strategy is only feasible at this bsz if every dp rank gets a
        # whole (micro)batch — otherwise the runtime config rejects it
        # (HybridParallelConfig.validate global_bsz % dp); under pp>1 the
        # 1F1B engine additionally requires the MICROBATCH (bsz/chunks) to
        # shard evenly over the layer's dp degree (uneven shards would pad
        # with collective-permutes inside stage-divergent branches)
        n_layers = sum(lc["layer_num"] for lc in self.layer_configs)
        type_bounds = list(np.cumsum([lc["layer_num"] for lc in self.layer_configs])[:-1])

        def ok(s):
            if s[2] > bsz or bsz % s[2] != 0:
                return False
            if not self.allow_sequence_sharding:
                info = s[3] if len(s) > 3 else {}
                if info.get("cp", 1) > 1 or info.get("sp", 0):
                    return False
            if s[0] > 1 and (bsz // chunks) % s[2] != 0:
                return False
            if s[0] > 1:
                if self.num_layertype == 1:
                    # generic 1F1B accepts uneven divisions; only pp beyond
                    # the layer count is impossible
                    if s[0] > n_layers:
                        return False
                    # ring cp>1 requires stage-uniform strategies, which an
                    # uneven division can never satisfy
                    # (pipeline_1f1b.validate_1f1b_config)
                    if n_layers % s[0] != 0 and (s[3] if len(s) > 3 else {}).get("cp", 1) > 1:
                        return False
                else:
                    # multi-type engines: equal layers per stage and no ring
                    # cp (pipeline_1f1b_encdec/swin validate_*_config reject
                    # it). Type-boundary/stage-boundary alignment is only
                    # required when the family says so (enc-dec yes; swin
                    # supports mid-stage patch merges but no ulysses sp —
                    # validate_swin_config)
                    if (s[3] if len(s) > 3 else {}).get("cp", 1) > 1:
                        return False
                    if n_layers % s[0] != 0:
                        return False
                    lps = n_layers // s[0]
                    if self.align_type_boundaries and any(
                        b % lps != 0 for b in type_bounds
                    ):
                        return False
            if not (min_tp <= s[1] <= max_tp):
                return False
            sp = (s[3] if len(s) > 3 else {}).get("sp", 0)
            if sp_search == 1 and sp:
                return False
            if sp_search == 2 and not sp:
                return False
            return True

        feasible = [s for s in self.strategies if ok(s)]
        if not feasible:
            if tlog:
                tlog.info("no feasible strategies")
            return dict(cost=float("inf"), strategies=None, remaining=0, vtp=1,
                        pp=1, bsz=bsz, chunks=chunks, vsp=vsp, embed_sdp=embed_sdp,
                        pp_division=None)
        if tlog:
            tlog.info("%d feasible strategies" % len(feasible))
        dpom = DpOnModel(
            feasible,
            MemoryCostModel,
            TimeCostModel,
            OtherTimeCostModel,
            ma_list, ta_list, pa_list, pma_list, pha_list,
            max_mem=int(self.args.memory_constraint * 1024),
            use_pipeline_costmodel=self.args.use_pipeline_costmodel,
            layer_nums=[lc["layer_num"] for lc in self.layer_configs],
            multi_layer_type=self.num_layertype > 1,
            pp_stage_dict=self._pp_stage_dict(bundles),
            comm_coe_dict=self.comm_coe_dict,
            gpu_num=self.world_size,
            mem_cache_mb=int(self.args.mem_cache_gb * 1024),
            fine_grained_mode=self.args.fine_grained_mode,
            sequence_len=[lc["seq_len"] for lc in self.layer_configs],
            logger=self.logger,
        )
        cost, res, rem, vtp, pp = dpom.fit(
            bsz, mbsz=max(1, bsz * min_tp // self.world_size), min_tp=min_tp,
            max_tp=max_tp, vsp=vsp, embed_sdp=embed_sdp, chunks=chunks,
        )
        if res is not None and self.args.comm_quant != "off":
            cost, res = self._enforce_comm_quant_contract(
                cost, res, pp, vtp, vsp, bsz, bundles, tlog,
            )
        if tlog:
            tlog.info("result: cost=%s vtp=%s pp=%s remaining_mem=%s" % (cost, vtp, pp, rem))
            if res:
                for i, s in enumerate(res):
                    tlog.info("layer %d: %s" % (i, form_strategy(s)))
        result = dict(cost=cost, strategies=res, remaining=rem, vtp=vtp, pp=pp,
                      min_tp=min_tp, max_tp=max_tp, sp_search=sp_search,
                      bsz=bsz, chunks=chunks, vsp=vsp, embed_sdp=embed_sdp,
                      pp_division=dpom.pp_stage_dict.get(pp))
        if res is not None and pp > 1 and self.num_layertype == 1:
            # mirror the runtime validator: the per-layer DP can mix cp>1
            # and cp=1 layers across stages, which validate_1f1b_config
            # rejects (ring collectives must run identically on every stage)
            # — an emitted config must ALWAYS construct
            from galvatron_tpu_torch.parallel.pipeline_1f1b import validate_1f1b_config

            try:
                validate_1f1b_config(self.result_to_config(result))
            except ValueError as e:
                if tlog:
                    tlog.info("winner rejected by runtime validator: %s" % e)
                return dict(result, cost=float("inf"), strategies=None)
        return result

    def _enforce_comm_quant_contract(self, cost, res, pp, vtp, vsp, bsz,
                                     bundles, tlog=None):
        """Post-DP guards for the comm-precision axis.

        (a) Runtime-support mirror: quantized layers inside a config the
        quantized ring cannot run (pp>1, any tp/cp/sp layer, vocab
        parallelism — the GLS013 contract) are stripped back to 'none' so
        an emitted config ALWAYS lints clean; (b) the user accuracy budget
        (``--comm_quant_budget``, max fraction of layers quantized):
        layers whose modeled time saving is smallest are de-quantized
        first, the reported cost adjusted by each flip's delta."""

        def quantized(s):
            info = s[3] if len(s) > 3 else {}
            return info.get("gcd", "none") != "none" or \
                info.get("pcd", "none") != "none"

        def strip(s):
            info = dict(s[3]) if len(s) > 3 else {}
            info.pop("gcd", None)
            info.pop("pcd", None)
            return [s[0], s[1], s[2], info]

        if not any(quantized(s) for s in res):
            return cost, res
        mixed = pp > 1 or vtp > 1 or vsp or any(
            s[1] > 1 or (s[3] if len(s) > 3 else {}).get("cp", 1) > 1
            or (s[3] if len(s) > 3 else {}).get("sp", 0) for s in res
        )
        if mixed:
            if tlog:
                tlog.info("comm_quant: winner mixes quantized layers into a "
                          "non-pure-dp config; stripping (GLS013 contract)")
            return cost, [strip(s) if quantized(s) else s for s in res]
        budget = float(self.args.comm_quant_budget)
        n_quant = sum(1 for s in res if quantized(s))
        allowed = int(math.floor(budget * len(res) + 1e-9))
        if n_quant <= allowed:
            return cost, res
        ma_list, ta_list, pa_list, pma_list, pha_list = bundles
        layer_type_ids = []
        for t, lc in enumerate(self.layer_configs):
            layer_type_ids += [t] * lc["layer_num"]

        def layer_ms(s, t):
            return TimeCostModel(
                s, bsz, model_args=ma_list[t], train_args=ta_list[t],
                parallel_args=pa_list[t], profile_model_args=pma_list[t],
                profile_hardware_args=pha_list[t],
            ).gen_result()

        flips = []  # (saving, layer index, stripped twin, delta)
        for i, s in enumerate(res):
            if not quantized(s):
                continue
            t = layer_type_ids[i]
            twin = strip(s)
            delta = layer_ms(twin, t) - layer_ms(s, t)  # cost of flipping
            flips.append((delta, i, twin))
        flips.sort(key=lambda f: f[0])  # cheapest flips (smallest saving) first
        res = list(res)
        for delta, i, twin in flips[: n_quant - allowed]:
            res[i] = twin
            cost += delta
        if tlog:
            tlog.info("comm_quant budget %.2f: de-quantized %d of %d layers"
                      % (budget, n_quant - allowed, n_quant))
        return cost, res

    def parallelism_optimization(self) -> Optional[dict]:
        """Outer loop over bsz x chunks x vsp x embed_sdp (reference
        search_engine.py:339-537). Maximises throughput = bsz / iter_time."""
        a = self.args
        best, best_throughput = None, -1.0
        bszs = [a.settle_bsz] if a.settle_bsz else list(
            range(a.min_bsz, (a.max_bsz or a.min_bsz * 8) + 1, a.bsz_scale)
        )
        chunk_opts = [a.settle_chunk] if a.settle_chunk else [1, 2, 4, 8]
        vsp_opts = [a.vsp] if a.vsp in (0, 1) else ([0, 1] if a.sp_space in ("sp", "tp+sp") else [0])
        esdp_opts = [bool(a.embed_sdp)] if a.embed_sdp in (0, 1) else [False, True]
        # min_tp x max_tp x sp-sub-space sweep (reference search_engine.py:
        # 348-371): min_tp floors the per-layer AND vocab tp candidates (and
        # normalises the microbatch the cost models price); sp_search splits
        # the space into tp-style / ulysses / mixed sub-searches
        max_strategy_tp = max((s[1] for s in self.strategies), default=1)
        min_tps = []
        t = 1
        while t <= min(a.max_tp_deg, self.world_size, max_strategy_tp):
            min_tps.append(t)
            t *= 2
        if a.disable_vtp:
            min_tps = [1]
        # sp_search 1/2 are strict SUBSETS of 3; a per-layer DP's optimum over
        # the union dominates both, so only the union runs per sp_space
        # (the reference sweeps the subsets too, mainly for per-task logs)
        sp_opts = {"tp": [1], "sp": [2], "tp+sp": [3]}.get(a.sp_space, [3])
        tasks = [
            (bsz, chunks, min_tp, vsp, embed_sdp, sp_search)
            for bsz in bszs
            for chunks in chunk_opts
            if bsz % chunks == 0
            for min_tp in min_tps
            for vsp in vsp_opts
            for embed_sdp in esdp_opts
            for sp_search in sp_opts
        ]

        def run(t):
            return self.search_for_bsz_chunk(
                t[0], t[1], min_tp=t[2], vsp=t[3], embed_sdp=t[4], sp_search=t[5]
            )

        if a.parallel_search and len(tasks) > 1:
            # thread-parallel outer loop (reference --parallel_search,
            # search_engine.py:427-475): each task is an independent DP over
            # shared read-only tables; the C++ core releases no GIL but the
            # numpy/C work interleaves well enough to pay off on big sweeps
            from concurrent.futures import ThreadPoolExecutor

            workers = min(len(tasks), max(2, os.cpu_count() or 2))
            with ThreadPoolExecutor(max_workers=workers) as pool:
                results = list(pool.map(run, tasks))
        else:
            results = [run(t) for t in tasks]
        for r in results:
            if r["strategies"] is None or not np.isfinite(r["cost"]):
                continue
            throughput = r["bsz"] / r["cost"]
            if throughput > best_throughput:
                best, best_throughput = r, throughput
        self.best = best
        return best

    def serve_optimization(self) -> dict:
        """Latency-aware serving objective (``--objective serve``): enumerate
        the decode-compatible subset of the strategy space (pp=1, no cp, no
        ulysses, no activation checkpointing, no quantized collectives — the
        serve engine's layout contract, mirrored by GLS014), price prefill
        and decode per candidate with ServeTimeCostModel, and maximise
        decode tokens/s/chip subject to the weight+KV memory budget and the
        optional p99 TTFT / TPOT bounds. Raises a GLS014 DiagnosticError
        when nothing survives, carrying the nearest-miss rejections so the
        user sees WHICH bound refused, not just that one did."""
        a = self.args
        ma_list, ta_list, _, pma_list, pha_list = self._bundles(1)
        max_ctx = max(lc["seq_len"] for lc in self.layer_configs)
        if a.serve_page_size > 0:
            # the KV cache is paged: contexts occupy whole pages
            max_ctx = -(-max_ctx // a.serve_page_size) * a.serve_page_size

        def decode_compatible(s):
            info = s[3] if len(s) > 3 else {}
            return (
                s[0] == 1
                and info.get("cp", 1) == 1
                and not info.get("sp", 0)
                and not info.get("cpt", 0)
                and info.get("gcd", "none") == "none"
                and info.get("pcd", "none") == "none"
                # every dp replica needs a whole number of KV slots
                and s[2] <= a.serve_max_concurrency
                and a.serve_max_concurrency % s[2] == 0
            )

        candidates = [s for s in self.strategies if decode_compatible(s)]
        budget_mb = a.memory_constraint * 1024.0
        best, rejections = None, []
        for s in candidates:
            prefill = decode = mem = 0.0
            for t in range(self.num_layertype):
                r = ServeTimeCostModel(
                    s, concurrency=a.serve_max_concurrency, max_ctx=max_ctx,
                    hbm_gbps=a.serve_hbm_gbps, kv_frac=a.serve_kv_frac,
                    model_args=ma_list[t], train_args=ta_list[t],
                    profile_model_args=pma_list[t],
                    profile_hardware_args=pha_list[t],
                ).gen_result()
                prefill += r["prefill_ms"]
                decode += r["decode_ms"]
                mem += serve_memory_mb(
                    s, concurrency=a.serve_max_concurrency, max_ctx=max_ctx,
                    kv_frac=a.serve_kv_frac,
                    model_args=ma_list[t], train_args=ta_list[t],
                )
            ttft, tpot = prefill + decode, decode
            label = form_strategy(s)
            if mem > budget_mb:
                rejections.append("%s: %.0f MB > %.0f MB budget" % (label, mem, budget_mb))
                continue
            if a.p99_ttft_ms > 0 and ttft > a.p99_ttft_ms:
                rejections.append("%s: TTFT %.1f ms > %.1f ms" % (label, ttft, a.p99_ttft_ms))
                continue
            if a.p99_tpot_ms > 0 and tpot > a.p99_tpot_ms:
                rejections.append("%s: TPOT %.1f ms > %.1f ms" % (label, tpot, a.p99_tpot_ms))
                continue
            tput = a.serve_max_concurrency / decode * 1000.0 / self.world_size
            if best is None or tput > best["serve"]["tokens_per_s_per_chip"]:
                n_layers = sum(lc["layer_num"] for lc in self.layer_configs)
                best = dict(
                    cost=decode,
                    strategies=[list(s) for _ in range(n_layers)],
                    pp=1, bsz=a.serve_max_concurrency, chunks=1,
                    vtp=1, vsp=0, embed_sdp=0, pp_division=None,
                    serve=dict(
                        prefill_ms=prefill, decode_ms=decode,
                        ttft_ms=ttft, tpot_ms=tpot, memory_mb=mem,
                        tokens_per_s_per_chip=tput, max_ctx=max_ctx,
                        concurrency=a.serve_max_concurrency,
                    ),
                )
        if best is None:
            from galvatron_tpu_torch.analysis.diagnostics import DiagnosticError, make

            detail = "; ".join(rejections[:4]) if rejections else \
                "no decode-compatible strategy in the search space"
            raise DiagnosticError([make(
                "GLS014",
                "no feasible serving strategy for world_size=%d under budget "
                "%.1f GB, p99_ttft<=%s ms, p99_tpot<=%s ms (%s)" % (
                    self.world_size, a.memory_constraint,
                    ("%.0f" % a.p99_ttft_ms) if a.p99_ttft_ms > 0 else "inf",
                    ("%.0f" % a.p99_tpot_ms) if a.p99_tpot_ms > 0 else "inf",
                    detail,
                ),
                key="objective",
            )])
        if self.logger:
            self.logger.info("serve winner: %s" % best["serve"])
        self.best = best
        return best

    # ------------------------------------------------------------------- save
    def result_to_config(self, result: dict) -> HybridParallelConfig:
        layers = []
        for s in result["strategies"]:
            info = s[3] if len(s) > 3 else {}
            layers.append(
                LayerStrategy(
                    tp=s[1],
                    cp=info.get("cp", 1),
                    sp=info.get("sp", 0),
                    fsdp=info.get("fsdp", 0),
                    checkpoint=info.get("cpt", 0),
                    tp_consec=info.get("tp", 1),
                    grad_comm_dtype=info.get("gcd", "none"),
                    param_comm_dtype=info.get("pcd", "none"),
                    remat_policy=info.get("rp", "full"),
                )
            )
        return HybridParallelConfig(
            world_size=self.world_size,
            pp=result["pp"],
            layers=layers,
            global_bsz=result["bsz"],
            chunks=result["chunks"],
            pp_division=result.get("pp_division"),
            pipeline_type="pipedream_flush" if result["pp"] > 1 else "gpipe",
            default_dp_type=self.args.default_dp_type,
            vocab_tp=result["vtp"] if result["vtp"] > 0 else 1,
            vocab_sp=result["vsp"],
            embed_sdp=int(result["embed_sdp"]),
            comm_quant_block=self.args.comm_quant_block,
            # a serve-objective winner carries its KV sizing so `cli serve`
            # (and the serve linter's budget check) sees the searched values
            serve_max_concurrency=(
                self.args.serve_max_concurrency
                if self.args.objective == "serve" else 0
            ),
            serve_page_size=(
                self.args.serve_page_size
                if self.args.objective == "serve" else 0
            ),
        )

    def save_results(self, result: dict, path: Optional[str] = None) -> str:
        cfg = self.result_to_config(result)
        # lint the winner before emitting it: an emitted config must ALWAYS
        # construct and pass the engine validators at train time — a failure
        # here is a search-engine bug surfaced at search time, not minutes
        # into a GPU job. Warnings (resharding runs, inert flags) go to the
        # task log / stdout.
        from galvatron_tpu_torch.analysis import strategy_lint as _slint

        report = _slint.lint_hp(
            cfg, mode="serve" if self.args.objective == "serve" else None)
        for d in report.warnings:
            (self.logger.info if self.logger else print)("strategy lint: %s" % d.format())
        if not report.ok:
            from galvatron_tpu_torch.analysis.diagnostics import DiagnosticError

            raise DiagnosticError(report.errors)
        if getattr(self.args, "trace_lint", False):
            # the JAX package abstract-traces the winner's train step here
            # (its trace linter); the port has no counterpart yet
            raise ValueError("trace_lint: the trace linter is not ported yet "
                             "(ROADMAP queue 1 item 12a: the collective audit of "
                             "analysis/trace_lint.py)")
        path = path or os.path.join(
            self.config_dir,
            "galvatron_config_%s_%dgpus_%dGB_%s.json"
            % (
                self.model_name,
                self.world_size,
                int(self.args.memory_constraint),
                "bf16" if self.args.mixed_precision else "fp32",
            ),
        )
        cfg.save(path)
        return path
