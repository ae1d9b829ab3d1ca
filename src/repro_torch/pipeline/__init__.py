"""Graph structure and model registry."""
from repro_torch.pipeline.registry import MODELS, ModelSpec, get_model
from repro_torch.pipeline.sparse import BipartiteCSR

__all__ = ["BipartiteCSR", "MODELS", "ModelSpec", "get_model"]
