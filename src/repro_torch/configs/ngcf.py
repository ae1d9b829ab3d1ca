"""NGCF (paper's own model, Wang et al. SIGIR'19) at m-x25 scale:
full-graph BPR training, 3 layers, embed 128, batch 150K (paper §7).
The port's copy of ``repro/configs/ngcf.py``."""
import dataclasses

FAMILY = "gnnrecsys"
OPTIMIZER = "adam"


@dataclasses.dataclass(frozen=True)
class NGCFConfig:
    name: str
    n_users: int
    n_items: int
    n_edges: int
    embed_dim: int
    n_layers: int
    bpr_batch: int


# m-x25 scale (paper Table 2), edges padded to mesh-divisible size
FULL = NGCFConfig(name="ngcf-3l-128e", n_users=349_184, n_items=53_248,
                  n_edges=250_085_376, embed_dim=128, n_layers=3,
                  bpr_batch=150_528)
SMOKE = NGCFConfig(name="ngcf-smoke", n_users=64, n_items=48, n_edges=512,
                   embed_dim=16, n_layers=2, bpr_batch=64)

SHAPES = {
    "fullgraph_train": dict(kind="gnnrecsys_train"),
}
SKIP = {}
