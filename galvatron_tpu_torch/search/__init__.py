from galvatron_tpu_torch.search.cost_model import (
    MemoryCostModel,
    OtherTimeCostModel,
    TimeCostModel,
    pipeline_costmodel,
)
from galvatron_tpu_torch.search.cost_model_args import (
    ModelArgs,
    ParallelArgs,
    ProfileHardwareArgs,
    ProfileModelArgs,
    TrainArgs,
)
from galvatron_tpu_torch.search.dynamic_programming import DPAlg, DpOnModel
from galvatron_tpu_torch.search.engine import GalvatronSearchEngine

__all__ = [
    "MemoryCostModel",
    "TimeCostModel",
    "OtherTimeCostModel",
    "pipeline_costmodel",
    "ModelArgs",
    "TrainArgs",
    "ParallelArgs",
    "ProfileModelArgs",
    "ProfileHardwareArgs",
    "DPAlg",
    "DpOnModel",
    "GalvatronSearchEngine",
]
