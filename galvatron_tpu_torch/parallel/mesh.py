"""Per-layer axis assignment, as pure arithmetic on the strategy.

Port of the device-free half of ``galvatron_tpu/parallel/mesh.py``: the
per-stage device block is factored into binary sub-axes ``m0 .. m{k-1}``
(major -> minor) and each layer's strategy becomes an assignment of sub-axes
to the tp, cp and dp roles. `config.strategy.layer_runs` groups layers by
this *realised* assignment, so inert flag differences (``sp`` or
``tp_consec`` at tp=1) do not split a run — exactly as in the reference.

Building a device mesh (process groups) comes with the tp/dp slice; this
module holds no device state.
"""

from __future__ import annotations

from dataclasses import dataclass
from typing import Tuple


def subaxis_sizes(per_stage: int) -> Tuple[int, ...]:
    """Factor the per-pipeline-stage device count into binary sub-axes
    (major -> minor), with any odd remainder as a single leading axis."""
    sizes = []
    n = per_stage
    while n % 2 == 0 and n > 1:
        sizes.append(2)
        n //= 2
    if n > 1:
        sizes.insert(0, n)
    return tuple(sizes)


def subaxis_names(per_stage: int) -> Tuple[str, ...]:
    return tuple("m%d" % i for i in range(len(subaxis_sizes(per_stage))))


@dataclass(frozen=True)
class LayerAxes:
    """The sub-axis assignment realising one layer's strategy: ``dp``/``cp``/
    ``tp`` are tuples of sub-axis names (major -> minor); ``ulysses`` marks
    the tp axes carrying Ulysses sequence parallelism, ``megatron_sp``
    Megatron-SP activation sharding."""

    dp: Tuple[str, ...]
    cp: Tuple[str, ...]
    tp: Tuple[str, ...]
    ulysses: bool = False
    megatron_sp: bool = False
    zero3: bool = False
    zero_opt: bool = False  # optimizer state sharded over dp (zero1/2/3)


def _assign(names, sizes, tp: int, cp: int, tp_consec: bool):
    """Split sub-axes into (dp, cp, tp) groups by degree products."""

    def take_minor(names_left, sizes_left, degree, what):
        taken = []
        prod = 1
        while prod < degree:
            if not names_left:
                raise ValueError("cannot realise %s degree %d from sub-axes %s" % (what, degree, sizes))
            taken.insert(0, names_left[-1])
            prod *= sizes_left[-1]
            names_left, sizes_left = names_left[:-1], sizes_left[:-1]
        if prod != degree:
            raise ValueError("%s degree %d not a product of minor sub-axes %s" % (what, degree, sizes))
        return names_left, sizes_left, tuple(taken)

    if not tp_consec and tp > 1:
        # tp on the MAJOR axes: reverse, assign, un-reverse.
        rn, rs = tuple(reversed(names)), tuple(reversed(sizes))
        rn_left, rs_left, tp_ax = take_minor(rn, rs, tp, "tp")
        rn_left, rs_left, cp_ax = take_minor(rn_left, rs_left, cp, "cp")
        dp_ax = tuple(reversed(rn_left))
        return dp_ax, tuple(reversed(cp_ax)), tuple(reversed(tp_ax))
    names_left, sizes_left, tp_ax = take_minor(names, sizes, tp, "tp")
    names_left, sizes_left, cp_ax = take_minor(names_left, sizes_left, cp, "cp")
    return tuple(names_left), cp_ax, tp_ax


def _axes_from_strategy(config, tp: int, cp: int, ulysses: bool,
                        tp_consec: bool, fsdp: bool) -> LayerAxes:
    names = subaxis_names(config.per_stage_devices)
    sizes = subaxis_sizes(config.per_stage_devices)
    dp_ax, cp_ax, tp_ax = _assign(names, sizes, tp, cp, tp_consec)
    dp_type = "zero3" if fsdp else config.default_dp_type
    return LayerAxes(
        dp=dp_ax,
        cp=cp_ax,
        tp=tp_ax,
        ulysses=ulysses and tp > 1,
        megatron_sp=config.sequence_parallel and tp > 1 and not ulysses,
        zero3=dp_type == "zero3",
        zero_opt=dp_type in ("zero2", "zero3"),
    )


def layer_axes(config, layer_idx: int) -> LayerAxes:
    s = config.layers[layer_idx]
    return _axes_from_strategy(config, s.tp, s.cp, bool(s.sp), bool(s.tp_consec), bool(s.fsdp))


def vocab_axes(config) -> LayerAxes:
    """Axes for the embedding / lm-head layers (vocab_tp/vocab_sp/vocab_cp)."""
    return _axes_from_strategy(
        config, config.vocab_tp, config.vocab_cp, bool(config.vocab_sp), True,
        bool(config.embed_sdp),
    )
