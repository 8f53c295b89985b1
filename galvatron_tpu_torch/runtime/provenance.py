"""The provenance block of a checkpoint's integrity manifest.

Port of ``galvatron_tpu/runtime/elastic.py``'s `build_provenance`,
`model_config_digest` and `optimizer_digest`: what a later process needs to
decide whether (and how) it may resume a checkpoint — the strategy JSON it
was written under, the world size, the chunks and global batch, the
precision, a digest of the model's architecture and of the optimizer's
hyperparameters, and the memory budget an elastic re-search runs under.
A plain resume refuses a checkpoint of another strategy
(``runtime/checkpoint.py``, GLS206) or model (GLS201); ``--elastic
resume|search`` re-plans from this block (``runtime/elastic.py``).
"""

from __future__ import annotations

import dataclasses
import hashlib
import json
from typing import Any, Dict, Optional

from galvatron_tpu_torch.config.strategy import HybridParallelConfig

# model-config fields left out of the digest: precision and the attention
# path are runtime choices, not model identity
_DIGEST_EXCLUDE = ("compute_dtype", "param_dtype", "attn_impl")


def _stable_json(obj: Any) -> str:
    return json.dumps(obj, sort_keys=True, default=str)


def model_config_digest(model_cfg: Any) -> str:
    """sha256 over the model's architectural identity; a checkpoint whose
    digest differs is refused (GLS201): same-shaped state with other
    semantics would restore cleanly and train garbage."""
    if dataclasses.is_dataclass(model_cfg):
        fields = dataclasses.asdict(model_cfg)
    else:
        fields = {k: v for k, v in vars(model_cfg).items() if not k.startswith("_")}
    fields = {k: str(v) for k, v in fields.items() if k not in _DIGEST_EXCLUDE}
    return hashlib.sha256(_stable_json(fields).encode()).hexdigest()


def model_config_fields(model_cfg: Any) -> Dict[str, Any]:
    """The model config's constructor fields that its digest covers, as
    JSON values: what a checkpoint's ``meta.json`` records as
    ``model_config`` so that an offline tool rebuilds the saved model
    (`model_config_from_fields`; ``cli lint --ckpt --deep``)."""
    return {f.name: getattr(model_cfg, f.name) for f in dataclasses.fields(model_cfg)
            if f.init and f.name not in _DIGEST_EXCLUDE}


def model_config_from_fields(model_type: str, model_size: Optional[str],
                             fields: Dict[str, Any]) -> Any:
    """The model config `model_config_fields` recorded, rebuilt through the
    family's constructor (JSON lists back to tuples); a caller holds its
    `model_config_digest` to the checkpoint's."""
    from galvatron_tpu_torch.models.registry import get_family

    fam = get_family(model_type)
    return fam.config_fn(model_size or fam.default_size,
                         **{k: tuple(v) if isinstance(v, list) else v for k, v in fields.items()})


def optimizer_digest(opt_args: Any) -> str:
    """sha256 over the optimizer's hyperparameters (`OptimizerArgs`). A
    mismatch on resume is a warning: schedules legitimately change
    mid-run."""
    fields = dataclasses.asdict(opt_args) if dataclasses.is_dataclass(opt_args) else dict(opt_args)
    return hashlib.sha256(_stable_json({k: str(v) for k, v in fields.items()}).encode()).hexdigest()


def build_provenance(hp: HybridParallelConfig, model_cfg: Any, opt_args: Any = None,
                     memory_budget_gb: Optional[float] = None) -> Dict[str, Any]:
    """The manifest's provenance block (the reference's keys; the port's
    ranks are its devices, so ``device_count`` is the world size)."""
    prov: Dict[str, Any] = {
        "format": 1,
        "strategy": hp.to_json_dict(),
        "world_size": hp.world_size,
        "chunks": hp.chunks,
        "global_bsz": hp.global_bsz,
        "mixed_precision": hp.mixed_precision,
        "model_digest": model_config_digest(model_cfg),
        "device_count": hp.world_size,
    }
    if opt_args is not None:
        prov["optimizer"] = {"kind": type(opt_args).__name__,
                             "digest": optimizer_digest(opt_args)}
    if memory_budget_gb:
        prov["memory_budget_gb"] = float(memory_budget_gb)
    return prov
