"""gcn-cora [arXiv:1609.02907]: 2 layers, d_hidden 16, sym-norm mean agg.
The port's copy of ``repro/configs/gcn_cora.py``.

The model is fixed; each shape supplies its own graph (d_feat/classes):
  full_graph_sm : cora      (2708 n / 10556 e / 1433 f / 7 c) full-batch
  minibatch_lg  : reddit    (233k n / 114.6M e / 602 f / 41 c) fanout 15-10
  ogb_products  : products  (2.45M n / 61.9M e / 100 f / 47 c) full-batch
  molecule      : batched 30-node graphs (64 e, binary class), batch 128
SHAPES are the reference's dry-run cells, which ``launch/cells.py`` builds.
"""
from repro_torch.models.gcn import GCNConfig

FAMILY = "gnn"
OPTIMIZER = "adam"

FULL = GCNConfig(name="gcn-cora", n_layers=2, d_hidden=16, n_classes=7,
                 d_feat=1433)
SMOKE = GCNConfig(name="gcn-cora-smoke", n_layers=2, d_hidden=8, n_classes=3,
                  d_feat=32)

SHAPES = {
    "full_graph_sm": dict(kind="gnn_full", n_nodes=2708, n_edges=10556,
                          d_feat=1433, n_classes=7),
    "minibatch_lg": dict(kind="gnn_sampled", n_nodes=232_965,
                         n_edges=114_615_892, batch_nodes=1024,
                         fanouts=(15, 10), d_feat=602, n_classes=41),
    "ogb_products": dict(kind="gnn_full", n_nodes=2_449_029,
                         n_edges=61_859_140, d_feat=100, n_classes=47),
    "molecule": dict(kind="gnn_batched", n_nodes=30, n_edges=64, batch=128,
                     d_feat=64, n_classes=2),
}
SKIP = {}
