"""deepfm [arXiv:1703.04247]: 39 sparse fields, embed 10, MLP 400-400-400,
FM interaction.  Vocab 2^20 rows/field (criteo-hashed scale).  The port's
copy of ``repro/configs/deepfm.py`` (its SHAPES are the reference's
dry-run cells, not ported here)."""
from repro_torch.models.recsys_models import DeepFMConfig

FAMILY = "recsys"
OPTIMIZER = "adam"

FULL = DeepFMConfig(name="deepfm", n_sparse=39, embed_dim=10,
                    vocab=1_048_576, mlp_dims=(400, 400, 400))
SMOKE = DeepFMConfig(name="deepfm-smoke", n_sparse=5, embed_dim=4,
                     vocab=64, mlp_dims=(16, 16))
