"""LightGCN (paper's own model, He et al. SIGIR'20) at m-x25 scale.
The port's copy of ``repro/configs/lightgcn.py``."""
from repro_torch.configs.ngcf import NGCFConfig

FAMILY = "gnnrecsys"
OPTIMIZER = "adam"

FULL = NGCFConfig(name="lightgcn-3l-128e", n_users=349_184, n_items=53_248,
                  n_edges=250_085_376, embed_dim=128, n_layers=3,
                  bpr_batch=150_528)
SMOKE = NGCFConfig(name="lightgcn-smoke", n_users=64, n_items=48,
                   n_edges=512, embed_dim=16, n_layers=2, bpr_batch=64)

SHAPES = {
    "fullgraph_train": dict(kind="gnnrecsys_train"),
}
SKIP = {}
