"""dlrm-rm2 [arXiv:1906.00091]: 13 dense + 26 sparse (embed 64),
bot MLP 13-512-256-64, top MLP 512-512-256-1, dot interaction.
Tables: 26 x 10*2^20 rows x 64 — 69.8 GB of embeddings, the capacity-tier
resident of the recsys family.  The port's copy of
``repro/configs/dlrm_rm2.py`` (its SHAPES are the reference's dry-run
cells, not ported here)."""
from repro_torch.models.recsys_models import DLRMConfig

FAMILY = "recsys_dlrm"
OPTIMIZER = "adam"

FULL = DLRMConfig(name="dlrm-rm2", n_dense=13, n_sparse=26, embed_dim=64,
                  vocab=10 * 1_048_576, bot_mlp=(512, 256, 64),
                  top_mlp=(512, 512, 256, 1))
SMOKE = DLRMConfig(name="dlrm-rm2-smoke", n_dense=13, n_sparse=4,
                   embed_dim=8, vocab=64, bot_mlp=(16, 8),
                   top_mlp=(16, 1))
