"""PyTorch/CUDA port of ``repro`` for one NVIDIA H100.

Imports torch and numpy only — never JAX, never the ``repro`` package.
Five slices so far: the LightGCN serving path (synthetic data, both CSR
directions, the forward, streaming top-K, the ``Recommender`` and the
queue-fronted ``RecommenderService``); the training path
(``pipeline.build_pipeline`` → ``Pipeline.step_fn`` for NGCF, LightGCN
and GCN: loader, BPR loss, microbatch accumulation, large-batch schedule,
SGD/Adam); tiered ANN serving (``memory``: topologies, placement
policies, host-store tables in fp32 or int8, the ``HotRowCache``; the
block-pruned ``serving.ann.AnnIndex``); the seed COO path
(``core.graph``, ``core.sparse_ops``, NGCF at the dataflow levels O0-O3
and LightGCN in ``core.message_passing``, the full-graph training step
in ``core.train_step``, and the subgraph-training baseline in
``data.sampler`` and ``dist.subgraph``); and the Experiment API over
them (``api``: ``ExperimentSpec``, the presets, ``Experiment`` and
``Run.fit/resume/evaluate/recommend/service``; the fault-tolerant loop
in ``runtime``, checkpoints in ``checkpoint``, the architecture registry
in ``configs``, the Kronecker data source, and ``python -m
repro_torch.launch.train``).  Six hand-written CUDA kernels
(``kernels/csrc``), one for each Pallas kernel of the reference, carry
them; the CSR training backwards are kernels too.  Entry points run on
the card unless the caller passes ``device="cpu"``.
"""
