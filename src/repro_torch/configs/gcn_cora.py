"""gcn-cora [arXiv:1609.02907]: 2 layers, d_hidden 16, sym-norm mean agg.
The port's copy of ``repro/configs/gcn_cora.py``.

The model is fixed; each shape supplies its own graph (d_feat/classes):
  full_graph_sm : cora      (2708 n / 10556 e / 1433 f / 7 c) full-batch
  minibatch_lg  : reddit    (233k n / 114.6M e / 602 f / 41 c) fanout 15-10
  ogb_products  : products  (2.45M n / 61.9M e / 100 f / 47 c) full-batch
  molecule      : batched 30-node graphs (64 e, binary class), batch 128
The reference's SHAPES are cell shapes for its dry-runs, not ported here.
"""
from repro_torch.models.gcn import GCNConfig

FAMILY = "gnn"
OPTIMIZER = "adam"

FULL = GCNConfig(name="gcn-cora", n_layers=2, d_hidden=16, n_classes=7,
                 d_feat=1433)
SMOKE = GCNConfig(name="gcn-cora-smoke", n_layers=2, d_hidden=8, n_classes=3,
                  d_feat=32)
