"""xdeepfm [arXiv:1803.05170]: 39 sparse fields, embed 10, CIN 200-200-200,
MLP 400-400.  The port's copy of ``repro/configs/xdeepfm.py`` (its SHAPES
are the reference's dry-run cells, not ported here)."""
from repro_torch.models.recsys_models import XDeepFMConfig

FAMILY = "recsys"
OPTIMIZER = "adam"

FULL = XDeepFMConfig(name="xdeepfm", n_sparse=39, embed_dim=10,
                     vocab=1_048_576, cin_layers=(200, 200, 200),
                     mlp_dims=(400, 400))
SMOKE = XDeepFMConfig(name="xdeepfm-smoke", n_sparse=5, embed_dim=4,
                      vocab=64, cin_layers=(8, 8), mlp_dims=(16,))
