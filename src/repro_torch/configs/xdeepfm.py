"""xdeepfm [arXiv:1803.05170]: 39 sparse fields, embed 10, CIN 200-200-200,
MLP 400-400.  The port's copy of ``repro/configs/xdeepfm.py``; SHAPES are
the reference's dry-run cells, which ``launch/cells.py`` builds."""
from repro_torch.models.recsys_models import XDeepFMConfig

FAMILY = "recsys"
OPTIMIZER = "adam"

FULL = XDeepFMConfig(name="xdeepfm", n_sparse=39, embed_dim=10,
                     vocab=1_048_576, cin_layers=(200, 200, 200),
                     mlp_dims=(400, 400))
SMOKE = XDeepFMConfig(name="xdeepfm-smoke", n_sparse=5, embed_dim=4,
                      vocab=64, cin_layers=(8, 8), mlp_dims=(16,))

SHAPES = {
    "train_batch": dict(kind="recsys_train", batch=65_536),
    "serve_p99": dict(kind="recsys_serve", batch=512),
    "serve_bulk": dict(kind="recsys_serve", batch=262_144),
    "retrieval_cand": dict(kind="recsys_retrieval", batch=1,
                           n_candidates=1_048_576),
}
SKIP = {}
