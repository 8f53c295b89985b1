"""Online autotuner: measured-cost re-search and an in-memory strategy swap
mid-run.

Port of ``galvatron_tpu/runtime/autotune.py``, on the port's own search
(``search/engine.py``) and cost models. The tables the search starts from
are a model of the hardware; the run itself is the ground truth. Once the
steady-state detector (``obs/steady.py``) says the step time settled, this
module

1. **calibrates**: folds the measured steady step time, split by each
   LayerRun's FLOPs share, the overlap-hidden communication and the
   measured memory back into the profiler's table schema
   (`measured_model_profiles`), so the search runs again on *measured*
   tables through its usual code;
2. **re-plans**: the driver re-searches under the original memory budget
   with the global batch pinned (the trajectory continues), and `decide`
   compares the incumbent's predicted step time with the new winner's
   under a hysteresis margin and an amortization check: the predicted
   saving over the remaining steps must exceed the measured cost of a swap
   (the relayout plus the first step after it), learned from earlier swaps
   (`OnlineAutotuner`);
3. **applies**: the driver swaps through its live-migration path
   (``runtime/elastic.migrate``); this module only decides and keeps the
   books (swap-cost learning, realized-saving telemetry).

``--autotune observe`` runs 1-2 and logs the counterfactual; ``apply``
also performs 3. `emit_profiles` is the offline calibrator: a telemetry
stream to measured tables on disk, in the profiler's file layout.
"""

from __future__ import annotations

import copy
import statistics
from dataclasses import dataclass
from typing import Any, Dict, List, Optional, Tuple

from galvatron_tpu_torch.obs import steady as S
from galvatron_tpu_torch.obs import telemetry as T

__all__ = [
    "AutotuneConfig",
    "AutotuneDecision",
    "OnlineAutotuner",
    "emit_profiles",
    "measured_model_profiles",
    "predicted_step_ms",
]

# Floor on the compute share of the measured step attributed to the body
# layers: even a wildly mis-calibrated comm_hidden estimate can't drive
# the measured table negative.
_MIN_BODY_FRACTION = 0.1

# The memory ratio is clamped: compiled-memory accounting on small debug
# models can be off by more than the cost model's activation split, and an
# unbounded ratio would swing the search's memory feasibility wildly.
_MEM_RATIO_MIN, _MEM_RATIO_MAX = 0.2, 5.0


# ----------------------------------------------------------------- calibrator

def _scale_time_entry(entry: Any, ratio: float) -> Any:
    """Scale a computation-table entry; entries are either a scalar ms or
    an [m, c] pair (per-microbatch linear model) — scale both terms."""
    if isinstance(entry, (list, tuple)):
        return [float(v) * ratio for v in entry]
    return float(entry) * ratio


def _scale_activations(mem_cfg: Dict[str, Any], ratio: float) -> None:
    """Scale activation entries in-place; parameter/model-state sizes are
    exact analytic byte counts and stay untouched."""
    for key, val in mem_cfg.items():
        if key.startswith("layertype_"):
            act = val.get("tp_activation_per_bsz_dict")
            if isinstance(act, dict):
                for k in act:
                    act[k] = float(act[k]) * ratio
        elif key in ("other_memory_pp_off",):
            act = val.get("activation")
            if isinstance(act, dict):
                for k in act:
                    act[k] = float(act[k]) * ratio
        elif key in ("other_memory_pp_on",):
            for stage in val.values():
                act = stage.get("activation") if isinstance(stage, dict) else None
                if isinstance(act, dict):
                    for k in act:
                        act[k] = float(act[k]) * ratio


def measured_model_profiles(
    base_time: Dict[str, Any],
    base_memory: Dict[str, Any],
    layer_run_rows: List[Dict[str, Any]],
    steady_step_ms: Optional[float],
    comm_hidden_ms: float = 0.0,
    compiled_memory_mb: Optional[float] = None,
    pred_comm_ms: float = 0.0,
) -> Optional[Tuple[Dict[str, Any], Dict[str, Any]]]:
    """Fold a measured steady step into the profiler's table schema.

    ``base_time``/``base_memory`` are the tables the incumbent's
    predictions were priced on (analytic or profiled); ``layer_run_rows``
    are the per-LayerRun prediction rows (``predict_layer_runs`` output or
    the equivalent ``layer_run`` telemetry events) carrying
    ``predicted_ms`` and ``flops_share``. The measured step is split by
    FLOPs share; overlap-hidden comm and the modeled communication price
    ``pred_comm_ms`` (the hardware-table part of the prediction — see
    ``calibrate_from_run`` for how it is derived) are subtracted, because
    the computation table must absorb only the COMPUTE miss: the search
    keeps pricing collectives from the hardware tables, so the calibrated
    ratio solves ``compute * r + comm = measured`` rather than uniformly
    inflating a comm-dominated prediction. Memory entries rescale by
    compiled/predicted when the compiled-step memory is known.

    Returns (time_config, memory_config) in the exact schema
    ``search_surviving_strategy`` / ``predict_layer_runs`` consume, or
    None when the inputs cannot support a calibration (no steady step, no
    usable rows)."""
    if steady_step_ms is None or steady_step_ms <= 0 or not layer_run_rows:
        return None

    body = [r for r in layer_run_rows
            if r.get("run", -1) >= 0 and r.get("predicted_ms") is not None]
    head = [r for r in layer_run_rows if r.get("run", -1) < 0]
    if not body:
        return None

    share_body = sum(float(r.get("flops_share") or 0.0) for r in body)
    pred_body = sum(float(r["predicted_ms"]) for r in body)
    if share_body <= 0 or pred_body <= 0:
        return None

    compute_pred = pred_body - float(pred_comm_ms or 0.0)
    if compute_pred <= 0:
        # the base prediction says this step is all communication; there is
        # no compute entry a measured-compute ratio could land on
        return None
    measured_body = max(
        steady_step_ms * share_body
        - float(comm_hidden_ms or 0.0) - float(pred_comm_ms or 0.0),
        _MIN_BODY_FRACTION * steady_step_ms * share_body,
    )
    ratio_body = measured_body / compute_pred

    # The embed/head row carries FLOPs share but (analytically) no priced
    # time; when it is priced, calibrate other_time on its own ratio, else
    # inherit the body ratio — same silicon, same scale error.
    ratio_head = ratio_body
    if head:
        share_head = sum(float(r.get("flops_share") or 0.0) for r in head)
        pred_head = sum(float(r["predicted_ms"]) for r in head
                        if r.get("predicted_ms") is not None)
        if share_head > 0 and pred_head > 0:
            ratio_head = steady_step_ms * share_head / pred_head

    time_cfg: Dict[str, Any] = {}
    for key, entry in base_time.items():
        if key.startswith("layertype_"):
            time_cfg[key] = _scale_time_entry(entry, ratio_body)
        elif key == "other_time":
            time_cfg[key] = _scale_time_entry(entry, ratio_head)
        else:
            time_cfg[key] = copy.deepcopy(entry)

    mem_cfg = copy.deepcopy(base_memory)
    if compiled_memory_mb and compiled_memory_mb > 0:
        pred_mem = sum(float(r.get("predicted_memory_mb") or 0.0) for r in body)
        if pred_mem > 0:
            ratio_mem = compiled_memory_mb / pred_mem
            ratio_mem = min(max(ratio_mem, _MEM_RATIO_MIN), _MEM_RATIO_MAX)
            _scale_activations(mem_cfg, ratio_mem)
    return time_cfg, mem_cfg


def calibrate_from_run(
    cfg: Any,
    hp: Any,
    base_time: Dict[str, Any],
    base_memory: Dict[str, Any],
    layer_run_rows: List[Dict[str, Any]],
    steady_step_ms: Optional[float],
    comm_hidden_ms: float = 0.0,
    compiled_memory_mb: Optional[float] = None,
) -> Optional[Tuple[Dict[str, Any], Dict[str, Any]]]:
    """The full calibration recipe: price the incumbent's communication on
    the base tables (a zeroed-compute pricing pass — what the cost model
    charges when every computation entry is 0 is exactly the hardware-table
    part), then fold the measured steady step into the tables with that
    comm price separated out (see ``measured_model_profiles``)."""
    if steady_step_ms is None:
        return None
    zero_time = {
        k: _scale_time_entry(v, 0.0)
        if (k.startswith("layertype_") or k == "other_time")
        else copy.deepcopy(v)
        for k, v in base_time.items()
    }
    try:
        pred_comm = predicted_step_ms(cfg, hp, zero_time, base_memory) or 0.0
    except Exception:
        pred_comm = 0.0
    return measured_model_profiles(
        base_time, base_memory, layer_run_rows, steady_step_ms,
        comm_hidden_ms=comm_hidden_ms, compiled_memory_mb=compiled_memory_mb,
        pred_comm_ms=pred_comm,
    )


def predicted_step_ms(
    cfg: Any,
    hp: Any,
    time_config: Optional[dict] = None,
    memory_config: Optional[dict] = None,
) -> Optional[float]:
    """Price a candidate strategy on the given tables: the summed
    per-LayerRun predicted time. Both the incumbent and the searched
    winner are priced through this one function so the hysteresis
    comparison is apples-to-apples."""
    from galvatron_tpu_torch.obs.attribution import predict_layer_runs

    rows = predict_layer_runs(
        cfg, hp, time_config=time_config, memory_config=memory_config)
    if not rows:
        return None
    total = sum(float(r["predicted_ms"]) for r in rows
                if r.get("predicted_ms") is not None)
    return total if total > 0 else None


# ------------------------------------------------------------------ decisions

@dataclass
class AutotuneConfig:
    """Knobs for the online decision loop.

    ``swap_cost_ms`` starts at 0 — an optimistic prior, so the first
    justified swap is never blocked by an unmeasured cost; every
    performed swap replaces it with the measured relayout wall time plus
    the first-step recompile spike (see ``OnlineAutotuner.observe_step``).
    """

    mode: str = "off"  # off | observe | apply
    margin: float = 0.05
    window: int = 5
    rel_std: float = 0.15
    swap_cost_ms: float = 0.0


@dataclass
class AutotuneDecision:
    """Outcome of one planning epoch; ``reason`` is one of ``swap``,
    ``hysteresis``, ``amortization``, ``identical``, ``infeasible``."""

    reason: str
    swap: bool
    incumbent_ms: Optional[float] = None
    winner_ms: Optional[float] = None
    predicted_saving_ms: Optional[float] = None
    remaining_steps: Optional[int] = None
    swap_cost_ms: Optional[float] = None
    target_hp: Any = None


class OnlineAutotuner:
    """Decision bookkeeping for the driver's drain loop.

    The driver pushes each drained step's wall time via ``observe_step``;
    when the detector settles, ``plan_pending`` goes True (once per
    measurement epoch). The driver then builds measured tables, searches,
    prices, and calls ``decide``; if it performs the swap it calls
    ``mark_swapped`` with the relayout wall time, which starts a new
    epoch. When the post-swap epoch re-settles, the tuner emits the
    ``action="realized"`` telemetry row comparing before/after steady
    step times against the predicted saving."""

    def __init__(self, config: AutotuneConfig):
        self.config = config
        self.detector = S.SteadyStateDetector(
            window=config.window, rel_std=config.rel_std)
        self.swaps = 0
        self.plans = 0
        self._planned_epoch = False
        # swap-in-flight bookkeeping
        self._await_first_step = False
        self._relayout_wall_ms = 0.0
        self._pre_swap_steady_ms: Optional[float] = None
        self._pre_swap_predicted_saving: Optional[float] = None
        self._swap_iteration: Optional[int] = None
        self._realized_emitted = True  # nothing pending until a swap happens

    # -- driver-facing surface --------------------------------------------

    @property
    def plan_pending(self) -> bool:
        return self.detector.settled and not self._planned_epoch

    def observe_step(self, iter_ms: Optional[float], iteration: Optional[int] = None) -> None:
        """Feed one drained step. The first step after a swap is the
        recompile spike: it funds the swap-cost estimate and is excluded
        from the new epoch's series."""
        if iter_ms is None:
            return
        if self._await_first_step:
            self._await_first_step = False
            spike = 0.0
            if self._pre_swap_steady_ms is not None:
                spike = max(float(iter_ms) - self._pre_swap_steady_ms, 0.0)
            self.config.swap_cost_ms = self._relayout_wall_ms + spike
            return
        settled_before = self.detector.settled
        self.detector.push(iter_ms)
        if (not settled_before and self.detector.settled
                and not self._realized_emitted):
            self._emit_realized(iteration)

    def steady_step_ms(self) -> Optional[float]:
        return self.detector.steady_step_ms()

    def decide(
        self,
        incumbent_ms: Optional[float],
        winner_ms: Optional[float],
        remaining_steps: int,
        identical: bool,
        target_hp: Any = None,
    ) -> AutotuneDecision:
        """Hysteresis + amortization gate. Marks this epoch planned —
        one decision per settle."""
        self._planned_epoch = True
        self.plans += 1
        common = dict(
            incumbent_ms=incumbent_ms, winner_ms=winner_ms,
            remaining_steps=remaining_steps,
            swap_cost_ms=self.config.swap_cost_ms, target_hp=target_hp,
        )
        if incumbent_ms is None or winner_ms is None:
            return AutotuneDecision(reason="infeasible", swap=False, **common)
        saving = incumbent_ms - winner_ms
        common["predicted_saving_ms"] = saving
        if identical:
            return AutotuneDecision(reason="identical", swap=False, **common)
        if saving <= self.config.margin * incumbent_ms:
            return AutotuneDecision(reason="hysteresis", swap=False, **common)
        if saving * max(remaining_steps, 0) <= self.config.swap_cost_ms:
            return AutotuneDecision(reason="amortization", swap=False, **common)
        return AutotuneDecision(reason="swap", swap=True, **common)

    def mark_swapped(
        self,
        iteration: int,
        relayout_wall_ms: float,
        predicted_saving_ms: Optional[float] = None,
    ) -> None:
        """The driver performed the swap: start a fresh measurement epoch
        and arm the realized-saving comparison."""
        self.swaps += 1
        self._relayout_wall_ms = float(relayout_wall_ms)
        self._pre_swap_steady_ms = self.detector.steady_step_ms()
        self._pre_swap_predicted_saving = predicted_saving_ms
        self._swap_iteration = iteration
        self._await_first_step = True
        self._realized_emitted = False
        self.detector.reset()
        self._planned_epoch = False

    # -- internals ---------------------------------------------------------

    def _emit_realized(self, iteration: Optional[int]) -> None:
        self._realized_emitted = True
        after = self.detector.steady_step_ms()
        before = self._pre_swap_steady_ms
        realized = None
        if before is not None and after is not None:
            realized = before - after
        T.emit(
            "autotune",
            action="realized",
            iter=iteration if iteration is not None else self._swap_iteration,
            mode=self.config.mode,
            step_ms_before=before,
            step_ms_after=after,
            realized_saving_ms=realized,
            predicted_saving_ms=self._pre_swap_predicted_saving,
        )


# --------------------------------------------------------- offline calibrator

def _duck_model_config(rs: Dict[str, Any]) -> Any:
    """Rebuild the minimum model-shape object the analytic tables need
    from a run_start event's calibration fields."""
    from types import SimpleNamespace

    hidden = int(rs["hidden_size"])
    heads = int(rs["num_heads"])
    return SimpleNamespace(
        hidden_size=hidden,
        num_heads=heads,
        num_kv_heads=int(rs.get("num_kv_heads") or heads),
        ffn_hidden=int(rs.get("ffn_hidden") or 4 * hidden),
        vocab_size=int(rs["vocab_size"]),
        max_seq_len=int(rs["seq_len"]),
        num_layers=int(rs["num_layers"]),
        activation=rs.get("activation") or "gelu",
    )


def emit_profiles(
    events: List[Dict[str, Any]],
    out_dir: str,
    window: int = 5,
    rel_std: float = 0.15,
) -> Dict[str, str]:
    """Offline calibrator: turn a telemetry JSONL stream into measured
    per-layer time/memory tables on disk, in the profiler's exact file
    layout, so ``search --time_profile_path/--memory_profile_path``
    consumes them directly.

    Raises ValueError when the stream cannot support calibration (no
    run_start with model-shape fields — telemetry predating this version —
    or no usable step series)."""
    import os

    from galvatron_tpu_torch.runtime import elastic as els
    from galvatron_tpu_torch.utils.jsonio import write_json_config

    by_type: Dict[str, List[Dict[str, Any]]] = {}
    for ev in events:
        by_type.setdefault(ev.get("type", ""), []).append(ev)

    starts = by_type.get("run_start", [])
    if not starts:
        raise ValueError("no run_start event; cannot identify the model")
    rs = starts[-1]
    if not all(rs.get(k) is not None
               for k in ("hidden_size", "num_heads", "vocab_size",
                         "seq_len", "num_layers")):
        raise ValueError(
            "run_start lacks model-shape calibration fields; the telemetry "
            "predates them — re-run train with this version to calibrate")
    cfg = _duck_model_config(rs)
    world = int(rs.get("world_size") or 1)

    st = S.detect(
        [ev.get("iter_ms") for ev in by_type.get("step", [])],
        window=window, rel_std=rel_std)
    if st.start_index is None:
        raise ValueError("no step events with iter_ms; nothing to calibrate on")
    tail = [float(ev["iter_ms"]) for ev in by_type.get("step", [])
            if ev.get("iter_ms") is not None][st.start_index:]
    steady_ms = float(statistics.median(tail))

    rows = [ev for ev in by_type.get("layer_run", [])]
    comm_hidden = sum(float(ev.get("comm_hidden_ms") or 0.0)
                      for ev in by_type.get("tp_overlap", []))
    compiled_mb = None
    for ev in by_type.get("compile", []):
        if ev.get("compiled_memory_mb") is not None:
            compiled_mb = float(ev["compiled_memory_mb"])

    base = els.analytic_model_profiles(cfg, max_tp=world)
    if base is None:
        raise ValueError("model family outside the analytic tables; cannot "
                         "build a calibration baseline")
    hp = None
    if rs.get("strategy"):
        try:
            from galvatron_tpu_torch.config.strategy import HybridParallelConfig

            hp = HybridParallelConfig.from_json(
                dict(rs["strategy"]), world_size=world)
        except Exception:
            hp = None  # comm price falls back to 0 (pure-compute scaling)
    if hp is not None:
        tables = calibrate_from_run(
            cfg, hp, base[0], base[1], rows, steady_ms,
            comm_hidden_ms=comm_hidden, compiled_memory_mb=compiled_mb)
    else:
        tables = measured_model_profiles(
            base[0], base[1], rows, steady_ms,
            comm_hidden_ms=comm_hidden, compiled_memory_mb=compiled_mb)
    if tables is None:
        raise ValueError("no layer_run prediction rows in the telemetry; "
                         "run train with --telemetry to record them")
    time_cfg, mem_cfg = tables

    model_type = rs.get("model_type") or "model"
    mixed_precision = rs.get("mixed_precision") or "fp32"
    tag = "%s_hidden%d_head%d_seqlen%d" % (
        mixed_precision, cfg.hidden_size, cfg.num_heads, cfg.max_seq_len)
    os.makedirs(out_dir, exist_ok=True)
    time_path = os.path.join(
        out_dir, "computation_profiling_%s_%s.json" % (tag, model_type))
    mem_path = os.path.join(
        out_dir, "memory_profiling_%s_%s.json" % (tag, model_type))
    write_json_config(time_cfg, time_path)
    write_json_config(mem_cfg, mem_path)
    return {"computation": time_path, "memory": mem_path}
