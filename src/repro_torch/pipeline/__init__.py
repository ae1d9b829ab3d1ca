"""The training pipeline: graph structure, model registry, batching, the
engine (``build_pipeline`` / ``Pipeline`` / ``PipelineConfig``) and
sharded execution (``ShardPlan``)."""
from repro_torch.pipeline.engine import Pipeline, PipelineConfig, build_pipeline
from repro_torch.pipeline.plan import TrainPlan
from repro_torch.pipeline.registry import MODELS, ModelSpec, get_model
from repro_torch.pipeline.shard import ShardPlan
from repro_torch.pipeline.sparse import BipartiteCSR

__all__ = ["BipartiteCSR", "MODELS", "ModelSpec", "Pipeline",
           "PipelineConfig", "ShardPlan", "TrainPlan", "build_pipeline",
           "get_model"]
