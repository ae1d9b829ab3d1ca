"""Request coalescing queue, the service facade and the block-pruned ANN
index."""
from repro_torch.serving.ann import (AnnIndex, ann_index_nbytes, ann_topk,
                                     recall_against)
from repro_torch.serving.queue import (Batch, Clock, ManualClock, QueueFull,
                                       Request, RequestQueue, WallClock,
                                       bucket_for)
from repro_torch.serving.service import RecommenderService, Response

__all__ = ["AnnIndex", "Batch", "Clock", "ManualClock", "QueueFull",
           "RecommenderService", "Request", "RequestQueue", "Response",
           "WallClock", "ann_index_nbytes", "ann_topk", "bucket_for",
           "recall_against"]
