"""Cost-model argument bundles and the hardware-profile parser.

Port of ``galvatron_tpu/search/cost_model_args.py`` (reference:
galvatron/core/search_engine/cost_model_args.py:6-49). Field names and
defaults are the JAX package's, so profiled configs and tests translate
directly. `parse_hardware_profiles` is the one mapping from the hardware
JSONs to coefficients; the search engine and ``profiler/validate.py`` both
use it. ``quant_overhead_coe`` keeps its default 0.02 when the overlap file
lacks it, as the port's hardware profiler leaves it out (the quantized
collectives are ROADMAP queue 1 item 10)."""

from __future__ import annotations

from dataclasses import dataclass, field
from typing import Any, Callable, Dict, Optional


@dataclass
class ModelArgs:
    parameter_size: float = 48.0  # MB per layer at tp=1
    seq_length: int = 2048
    hidden_size: int = 4096
    layer_num: int = 24
    # multi-layer-type models (T5): per-type lists are built by the engine


@dataclass
class TrainArgs:
    mixed_precision: bool = True
    async_grad_reduce: bool = True
    # runtime reservation (the CUDA context, cuBLAS workspaces and the
    # allocator's slack), MB
    runtime_context_mem: float = 512.0


@dataclass
class ParallelArgs:
    use_zero2_for_dp: bool = False
    max_tp_deg: int = 8
    disable_vtp: bool = False
    sequence_parallel: bool = True
    sp_space: str = "tp"  # tp | tp+sp | sp
    pipeline_type: str = "gpipe"
    optimal_chunk_func: Optional[Callable] = None
    chunks: Optional[int] = None
    # blockwise-quantization block size for the comm-precision axis
    # (strategy info keys 'gcd'/'pcd'; parallel/quant_collectives.py):
    # prices the per-block fp32 scale overhead on the wire
    comm_quant_block: int = 64


@dataclass
class ProfileModelArgs:
    # per-layer forward time: scalar ms/layer/sample, or (m, c) linear fit in
    # per-tp batch (profile_mode=batch), or quadratic fit in seq
    forward_computation_time: Any = 5.0
    # activation MB per sample keyed by tp degree (str or int) + 'checkpoint'
    tp_activation_per_bsz_dict: Dict[Any, float] = field(default_factory=dict)
    other_memory_pp_off: Dict[str, Dict[Any, float]] = field(default_factory=dict)
    other_memory_pp_on: Dict[str, Dict[str, Dict[Any, float]]] = field(default_factory=dict)
    other_time_profiled: Any = 1.0  # ms for embed+cls forward per sample
    # measured backward-recompute fraction per remat policy (strategy info
    # key 'rp'): {policy: replayed share of the forward}, written by
    # profile_computation's per-policy fwd/bwd measurement; None falls back
    # to the analytic table in TimeCostModel
    remat_recompute_frac: Optional[Dict[str, float]] = None


@dataclass
class ProfileHardwareArgs:
    bct_fct_coe: float = 2.0  # backward/forward flops ratio
    extra_overhead: float = 0.0  # ms per iteration fixed overhead
    # allreduce cost coefficients: ms per MB, keyed '%d' / '%d_0' / '%d_1'
    # (group size x placement: "consec" (_1) is a contiguous run of ranks,
    # "nonconsec" (_0) a strided one)
    comm_coe_dict: Dict[str, float] = field(default_factory=dict)
    dp_overlap_coe: float = 1.1  # collective slowdown when overlapped
    bct_overlap_coe: float = 1.1  # compute slowdown when overlapped
    p2p_comm_coe_dict: Optional[Dict[int, float]] = None  # ms/MB per pp degree
    costmodel_coe: float = 1.0
    # per-degree collective time tables: {deg: {"popt": (m, c)}} in ms vs MB
    allreduce_dict: Dict[int, Dict[str, Any]] = field(default_factory=dict)
    all2all_dict: Dict[int, Dict[str, Any]] = field(default_factory=dict)
    # quantize+dequantize cost per fp32-MB per collective pass (ms/MB) —
    # the comm-precision axis's compute toll, measurable by the hardware
    # profiler (profiler/hardware.profile_quant_overhead); on a
    # compute-dominated profile this is what makes fp32 win the search
    quant_overhead_coe: float = 0.02


def default_optimal_chunk_func(local_bsz, strategy, mbsz, min_tp):
    """Reference optimal_chunk_func_default (search_engine.py:1090): chunks
    so each microbatch is ~mbsz samples."""
    import math

    if mbsz <= 0:
        return 1
    return max(1, int(math.ceil(local_bsz / mbsz)))


def parse_hardware_profiles(
    allreduce_bandwidth_config: Optional[Dict[str, Any]] = None,
    p2p_bandwidth_config: Optional[Dict[str, Any]] = None,
    overlap_config: Optional[Dict[str, Any]] = None,
    sp_time_config: Optional[Dict[str, Any]] = None,
) -> Dict[str, Any]:
    """Hardware-profile JSONs -> cost-model coefficient dicts (the ONE
    mapping both the search engine and profiler/validate consume: schemas
    match the reference hardware profiler, 'allreduce_size_%d_consec_%d' in
    GB/s, 'pp_size_%d', 'overlap_coe').

    Returns {comm_coe_dict (ms/MB), p2p_coe_dict (ms/MB per pp degree),
    overlap_coe, allreduce_dict, all2all_dict}."""
    comm_coe_dict: Dict[str, float] = {}
    for key, gbps in (allreduce_bandwidth_config or {}).items():
        if not key.startswith("allreduce_size_"):
            continue
        size_s, consec_s = key[len("allreduce_size_"):].split("_consec_")
        tag = (
            size_s
            if int(consec_s) == 1
            and ("allreduce_size_%s_consec_0" % size_s) not in allreduce_bandwidth_config
            else "%s_%s" % (size_s, consec_s)
        )
        # ms per MB = 1e3 / (GB/s * 1024)
        comm_coe_dict[tag] = 1000.0 / (float(gbps) * 1024.0)
    comm_coe_dict.setdefault("1", 0.0)
    p2p_coe_dict = {
        int(k[len("pp_size_"):]): 1000.0 / (float(v) * 1024.0)
        for k, v in (p2p_bandwidth_config or {}).items() if k.startswith("pp_size_")
    }
    return {
        "comm_coe_dict": comm_coe_dict,
        "p2p_coe_dict": p2p_coe_dict,
        "overlap_coe": float((overlap_config or {}).get("overlap_coe", 1.1)),
        "allreduce_dict": {int(k): v for k, v in ((sp_time_config or {}).get("allreduce", {})).items()},
        "all2all_dict": {int(k): v for k, v in ((sp_time_config or {}).get("all2all", {})).items()},
        # measured quant/dequant toll (ms per fp32-MB per pass), written by
        # profile_quant_overhead into the overlap config; analytic default
        "quant_overhead_coe": float(
            (overlap_config or {}).get("quant_overhead_coe", 0.02)),
    }
