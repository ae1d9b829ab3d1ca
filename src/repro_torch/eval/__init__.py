"""Streaming top-K evaluation and the serving facade."""
from repro_torch.eval.metrics import (evaluate_embeddings, ranked_hits,
                                      ranking_metrics)
from repro_torch.eval.recommender import Recommender
from repro_torch.eval.topk import streaming_topk, validate_user_ids

__all__ = ["Recommender", "evaluate_embeddings", "ranked_hits",
           "ranking_metrics", "streaming_topk", "validate_user_ids"]
