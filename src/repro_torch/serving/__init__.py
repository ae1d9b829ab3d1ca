"""Request coalescing queue and the service facade."""
from repro_torch.serving.queue import (Batch, Clock, ManualClock, QueueFull,
                                       Request, RequestQueue, WallClock,
                                       bucket_for)
from repro_torch.serving.service import RecommenderService, Response

__all__ = ["Batch", "Clock", "ManualClock", "QueueFull", "RecommenderService",
           "Request", "RequestQueue", "Response", "WallClock", "bucket_for"]
