"""dlrm-rm2 [arXiv:1906.00091]: 13 dense + 26 sparse (embed 64),
bot MLP 13-512-256-64, top MLP 512-512-256-1, dot interaction.
Tables: 26 x 10*2^20 rows x 64 — 69.8 GB of embeddings, the capacity-tier
resident of the recsys family.  The port's copy of
``repro/configs/dlrm_rm2.py``; SHAPES are the reference's dry-run
cells, which ``launch/cells.py`` builds."""
from repro_torch.models.recsys_models import DLRMConfig

FAMILY = "recsys_dlrm"
OPTIMIZER = "adam"

FULL = DLRMConfig(name="dlrm-rm2", n_dense=13, n_sparse=26, embed_dim=64,
                  vocab=10 * 1_048_576, bot_mlp=(512, 256, 64),
                  top_mlp=(512, 512, 256, 1))
SMOKE = DLRMConfig(name="dlrm-rm2-smoke", n_dense=13, n_sparse=4,
                   embed_dim=8, vocab=64, bot_mlp=(16, 8),
                   top_mlp=(16, 1))

SHAPES = {
    "train_batch": dict(kind="recsys_train", batch=65_536),
    "serve_p99": dict(kind="recsys_serve", batch=512),
    "serve_bulk": dict(kind="recsys_serve", batch=262_144),
    "retrieval_cand": dict(kind="recsys_retrieval", batch=1,
                           n_candidates=1_048_576),
}
SKIP = {}
