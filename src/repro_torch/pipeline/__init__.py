"""The training pipeline: graph structure, model registry, batching and
the engine (``build_pipeline`` / ``Pipeline`` / ``PipelineConfig``)."""
from repro_torch.pipeline.engine import Pipeline, PipelineConfig, build_pipeline
from repro_torch.pipeline.plan import TrainPlan
from repro_torch.pipeline.registry import MODELS, ModelSpec, get_model
from repro_torch.pipeline.sparse import BipartiteCSR

__all__ = ["BipartiteCSR", "MODELS", "ModelSpec", "Pipeline",
           "PipelineConfig", "TrainPlan", "build_pipeline", "get_model"]
