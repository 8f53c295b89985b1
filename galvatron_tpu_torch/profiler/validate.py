"""Cost-model validation: predicted against measured step time and memory.

Port of ``galvatron_tpu/profiler/validate.py``. For a (model config,
strategy) pair it predicts the per-GPU memory and the step time with the
SAME cost models the search uses (`predict_memory_mb`,
`predict_step_time_ms`: the JAX package's arithmetic, so both packages
predict the same numbers from the same tables) and measures them on the
port's own train step (``runtime.model_api.construct_hybrid_parallel_model``):

- memory: on the card, the caching allocator's peak over steady train steps
  (``max_memory_allocated``, after a warmup step built the Adam state):
  parameters, gradients, Adam moments, the batch and the activations. On
  the CPU, which has no allocator peak, the resident parameters and Adam
  state, one set of gradients, and the bytes autograd saved in a step
  (``profiler.model.SavedBytes``).
- time: the train step with CUDA events around it on the card (the step
  reads its loss, so each is drained), ``perf_counter`` on the CPU; the
  minimum over ``iters`` steps after a warmup step, as in the JAX package.

The ratios are measured / predicted; they are reported, never tuned away.
"""

from __future__ import annotations

import time
from dataclasses import dataclass
from typing import Any, Dict, List, Tuple

import numpy as np
import torch

from galvatron_tpu_torch.config.strategy import HybridParallelConfig
from galvatron_tpu_torch.search.cost_model import MemoryCostModel
from galvatron_tpu_torch.search.cost_model_args import (
    ModelArgs,
    ParallelArgs,
    ProfileModelArgs,
    TrainArgs,
)

MB = 2.0**20


@dataclass
class MemoryValidation:
    predicted_mb: float
    measured_mb: float
    predicted_layers_mb: float
    predicted_other_mb: float

    @property
    def ratio(self) -> float:
        return self.measured_mb / max(self.predicted_mb, 1e-9)


def _strategy_vector(hp: HybridParallelConfig, i: int):
    s = hp.layers[i]
    info = {"sp": s.sp, "cp": s.cp, "fsdp": s.fsdp, "cpt": s.checkpoint, "tp": s.tp_consec}
    return [hp.pp, s.tp, hp.dp(i), info]


def predict_memory_mb(
    hp: HybridParallelConfig,
    memory_config: Dict[str, Any],
    seq_len: int,
    hidden: int,
    *,
    mixed_precision: bool = True,
    layer_type_of=None,
) -> Dict[str, float]:
    """Per-chip memory prediction (MB) for stage 0 of `hp` using the search
    engine's MemoryCostModel on profiled tables."""
    n_layers = len(hp.layers)
    layer_type_of = layer_type_of or ([0] * n_layers)
    per_layer = []
    other = 0.0
    for i in range(n_layers):
        t = layer_type_of[i]
        ma = ModelArgs(
            parameter_size=memory_config["layertype_%d" % t]["parameter_size"],
            seq_length=seq_len, hidden_size=hidden, layer_num=n_layers,
        )
        pma = ProfileModelArgs(
            tp_activation_per_bsz_dict=memory_config["layertype_%d" % t][
                "tp_activation_per_bsz_dict"
            ],
            other_memory_pp_off=memory_config.get("other_memory_pp_off", {}),
            other_memory_pp_on=memory_config.get("other_memory_pp_on", {}),
        )
        m = MemoryCostModel(
            _strategy_vector(hp, i),
            global_batch_size=hp.global_bsz,
            mbsz=max(1, hp.global_bsz // max(hp.dp(i), 1)),
            min_tp=1,
            max_tp=max(s.tp for s in hp.layers),
            model_args=ma,
            train_args=TrainArgs(mixed_precision=mixed_precision,
                                 runtime_context_mem=0.0),
            parallel_args=ParallelArgs(chunks=hp.chunks, pipeline_type=hp.pipeline_type),
            profile_model_args=pma,
        )
        cost = m.get_memory_cost()
        per_layer.append(cost["enc_total"])
        if i == 0:
            vtp = hp.vocab_tp
            other_tbl = cost["other"]  # {vtp: [per-stage MB]}
            key = vtp if vtp in other_tbl else min(other_tbl)
            other = float(other_tbl[key][0])
    stage_of = hp.stage_of_layer
    stage0_layers = [per_layer[i] for i in range(n_layers) if stage_of[i] == 0]
    layers_mb = float(np.sum(stage0_layers))
    return {
        "layers_mb": layers_mb,
        "other_mb": other,
        "total_mb": layers_mb + other,
    }


def measure_train_steps(model, tx, iters: int = 3, seed: int = 0) -> Tuple[List[float], float]:
    """Run a warmup step, then `iters` timed steps of `model`'s train step
    on a seeded random batch; returns (step ms per timed step, peak MB of
    the timed steps) as the module docstring defines them."""
    from galvatron_tpu_torch.profiler.model import SavedBytes
    from galvatron_tpu_torch.runtime.dataloader import prepare_batch

    hp, cfg, dev = model.hp, model.cfg, model.device
    rng = np.random.RandomState(seed)
    tokens = rng.randint(0, cfg.vocab_size, (hp.global_bsz, cfg.max_seq_len))
    batch = prepare_batch(hp, tokens, device=dev)
    params = model.init_params(seed)
    opt_state = model.init_opt_state(tx, params)
    step = model.make_train_step(tx)
    params, opt_state, m = step(params, opt_state, batch)  # warmup
    float(m["loss"])
    cuda = dev.type == "cuda"
    saved = None
    if cuda:
        torch.cuda.synchronize(dev)
        torch.cuda.reset_peak_memory_stats(dev)
    else:
        saved = SavedBytes([p for mod in params.values() for p in mod.parameters()])
    times = []
    for _ in range(iters):
        if cuda:
            start = torch.cuda.Event(enable_timing=True)
            end = torch.cuda.Event(enable_timing=True)
            start.record()
            params, opt_state, m = step(params, opt_state, batch)
            float(m["loss"])
            end.record()
            end.synchronize()
            times.append(start.elapsed_time(end))
        else:
            t0 = time.perf_counter()
            with saved.hooks():
                params, opt_state, m = step(params, opt_state, batch)
            float(m["loss"])
            times.append((time.perf_counter() - t0) * 1e3)
    if cuda:
        peak = float(torch.cuda.max_memory_allocated(dev))
    else:
        param_bytes = sum(p.numel() * p.element_size()
                          for mod in params.values() for p in mod.parameters())
        state_bytes = sum(t.numel() * t.element_size() for s in opt_state.values()
                          for t in (list(s.mu.values()) + list(s.nu.values())))
        peak = float(2 * param_bytes + state_bytes + saved.total)
    return times, peak / MB


def measure_train_step_mb(model, tx) -> float:
    """Per-GPU peak memory (MB) of the train step."""
    return measure_train_steps(model, tx, iters=2)[1]


@dataclass
class TimeValidation:
    predicted_ms: float
    measured_ms: float

    @property
    def ratio(self) -> float:
        return self.measured_ms / max(self.predicted_ms, 1e-9)


def _hw_dicts(hw: Dict[str, Dict]) -> Dict[str, Any]:
    """HardwareProfiler.profile_all output -> the full coefficient bundle
    (comm_coe_dict, p2p_coe_dict, overlap_coe, allreduce_dict, all2all_dict),
    via the SAME parser the search engine uses
    (cost_model_args.parse_hardware_profiles)."""
    from galvatron_tpu_torch.search.cost_model_args import parse_hardware_profiles

    return parse_hardware_profiles(
        hw.get("allreduce"), hw.get("p2p"), hw.get("overlap"), hw.get("sp"),
    )


def predict_step_time_ms(
    hp: HybridParallelConfig,
    time_config: Dict[str, Any],
    memory_config: Dict[str, Any],
    hw: Dict[str, Dict],
    seq_len: int,
    hidden: int,
    *,
    mixed_precision: bool = True,
) -> float:
    """Per-iteration time prediction (ms) for `hp` with the SAME
    TimeCostModel + pipeline pricing the search uses (single layer type)."""
    from galvatron_tpu_torch.search.cost_model import (
        OtherTimeCostModel,
        TimeCostModel,
        pipeline_costmodel,
    )

    n_layers = len(hp.layers)
    hwp = _hw_dicts(hw)
    ma = ModelArgs(
        parameter_size=memory_config["layertype_0"]["parameter_size"],
        seq_length=seq_len, hidden_size=hidden, layer_num=n_layers,
    )
    ta = TrainArgs(mixed_precision=mixed_precision)
    pa = ParallelArgs(chunks=hp.chunks, pipeline_type=hp.pipeline_type)
    pma = ProfileModelArgs(
        forward_computation_time=time_config["layertype_0"],
        tp_activation_per_bsz_dict=memory_config["layertype_0"]["tp_activation_per_bsz_dict"],
        other_memory_pp_off=memory_config.get("other_memory_pp_off", {}),
        other_memory_pp_on=memory_config.get("other_memory_pp_on", {}),
        other_time_profiled=time_config.get("other_time", 1.0),
    )
    from galvatron_tpu_torch.search.cost_model_args import ProfileHardwareArgs

    pha = ProfileHardwareArgs(
        comm_coe_dict=hwp["comm_coe_dict"], dp_overlap_coe=hwp["overlap_coe"],
        bct_overlap_coe=hwp["overlap_coe"], p2p_comm_coe_dict=hwp["p2p_coe_dict"],
        allreduce_dict=hwp["allreduce_dict"], all2all_dict=hwp["all2all_dict"],
    )
    max_tp = max(s.tp for s in hp.layers)
    otc = OtherTimeCostModel(
        # the search's own mbsz for this model (engine.py search_for_bsz_chunk:
        # bsz*min_tp//world_size at min_tp=1), so the validated prediction is
        # the number the search actually scored
        mbsz=max(1, hp.global_bsz // hp.world_size),
        pp_deg=hp.pp, world_size=hp.world_size, vsp=hp.vocab_sp,
        embed_sdp=bool(getattr(hp, "embed_sdp", 0)),
        min_tp=1, max_tp=max(max_tp, hp.vocab_tp),
        sequence_length_list=[seq_len], model_args=ma, train_args=ta,
        parallel_args=pa, profile_model_args=pma, profile_hardware_args=pha,
    ).gen_result()
    key = hp.vocab_tp if hp.vocab_tp in otc else min(otc)
    other = otc[key]
    strategies = [_strategy_vector(hp, i) for i in range(n_layers)]
    return float(pipeline_costmodel(
        TimeCostModel,
        [n_layers], [ma], [ta], [pa], [pma], [pha],
        strategies, list(hp.pp_division), hp.chunks, hp.global_bsz,
        min_tp=1, other_time_cost=other,
    ))


def measure_step_time_ms(model, tx, iters: int = 3) -> float:
    """The train step's time (ms): the minimum over `iters` steps after a
    warmup step."""
    return float(np.min(measure_train_steps(model, tx, iters)[0]))


def _optimizer(tx):
    if tx is not None:
        return tx
    from galvatron_tpu_torch.runtime.optimizer import OptimizerArgs, get_optimizer_and_scheduler

    return get_optimizer_and_scheduler(OptimizerArgs(lr=1e-3))[0]


def _measure(cfg, hp: HybridParallelConfig, tx, device: str, iters: int) -> Tuple[List[float], float]:
    """(step ms per timed step, peak MB) of one build of the port's model
    under `hp`, in this process's group (a world of one when there is none)."""
    from galvatron_tpu_torch.runtime import distributed
    from galvatron_tpu_torch.runtime.model_api import construct_hybrid_parallel_model

    with distributed.process_group(device) as dev:
        model = construct_hybrid_parallel_model(cfg, hp, dev)
        return measure_train_steps(model, _optimizer(tx), iters)


def _time_validation(cfg, hp, time_config, memory_config, hw, times) -> TimeValidation:
    predicted = predict_step_time_ms(
        hp, time_config, memory_config, hw, cfg.max_seq_len, cfg.hidden_size,
        mixed_precision=(cfg.compute_dtype == torch.bfloat16),
    )
    return TimeValidation(predicted_ms=predicted, measured_ms=float(np.min(times)))


def _memory_validation(cfg, hp, memory_config, layer_type_of, peak_mb) -> MemoryValidation:
    pred = predict_memory_mb(
        hp, memory_config, cfg.max_seq_len, cfg.hidden_size,
        mixed_precision=(cfg.compute_dtype == torch.bfloat16),
        layer_type_of=layer_type_of,
    )
    return MemoryValidation(
        predicted_mb=pred["total_mb"],
        measured_mb=peak_mb,
        predicted_layers_mb=pred["layers_mb"],
        predicted_other_mb=pred["other_mb"],
    )


def validate(cfg, hp: HybridParallelConfig, time_config: Dict[str, Any],
             memory_config: Dict[str, Any], hw: Dict[str, Dict], tx=None, layer_type_of=None,
             device: str = "cuda", iters: int = 3) -> Tuple[TimeValidation, MemoryValidation]:
    """Both validations from ONE build and one run of `iters` steps: the
    step time is the fastest step's, the peak that of the same steps."""
    times, peak = _measure(cfg, hp, tx, device, iters)
    return (_time_validation(cfg, hp, time_config, memory_config, hw, times),
            _memory_validation(cfg, hp, memory_config, layer_type_of, peak))


def validate_time(cfg, hp: HybridParallelConfig, time_config: Dict[str, Any],
                  memory_config: Dict[str, Any], hw: Dict[str, Dict],
                  tx=None, device: str = "cuda", iters: int = 3) -> TimeValidation:
    """Predicted-vs-measured per-iteration time for one (config, strategy);
    `validate` gives it with the memory check from the same run."""
    times = _measure(cfg, hp, tx, device, iters)[0]
    return _time_validation(cfg, hp, time_config, memory_config, hw, times)


def validate_memory(cfg, hp: HybridParallelConfig, memory_config: Dict[str, Any], tx=None,
                    layer_type_of=None, device: str = "cuda") -> MemoryValidation:
    """Predicted-vs-measured per-GPU memory for one (config, strategy);
    `validate` gives it with the time check from the same run."""
    peak = _measure(cfg, hp, tx, device, 2)[1]
    return _memory_validation(cfg, hp, memory_config, layer_type_of, peak)
