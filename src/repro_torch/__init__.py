"""PyTorch/CUDA port of ``repro`` for one NVIDIA H100.

Imports torch and numpy only — never JAX, never the ``repro`` package.
This slice carries the LightGCN serving path: synthetic data, both CSR
directions, the LightGCN forward, streaming top-K, the ``Recommender``
and the queue-fronted ``RecommenderService``, on three hand-written CUDA
kernels (``kernels/csrc``).  Entry points run on the card unless the
caller passes ``device="cpu"``.
"""
