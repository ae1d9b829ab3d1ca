"""PyTorch/CUDA port of ``repro`` for one NVIDIA H100.

Imports torch and numpy only — never JAX, never the ``repro`` package.
Three slices so far: the LightGCN serving path (synthetic data, both CSR
directions, the forward, streaming top-K, the ``Recommender`` and the
queue-fronted ``RecommenderService``); the training path
(``pipeline.build_pipeline`` → ``Pipeline.step_fn`` for NGCF, LightGCN
and GCN: loader, BPR loss, microbatch accumulation, large-batch schedule,
SGD/Adam); and tiered ANN serving (``memory``: topologies, placement
policies, host-store tables in fp32 or int8, the ``HotRowCache``; the
block-pruned ``serving.ann.AnnIndex``).  Five hand-written CUDA kernels
(``kernels/csrc``) carry them; the training backwards are kernels too.  Entry points run on the card unless the
caller passes ``device="cpu"``.
"""
