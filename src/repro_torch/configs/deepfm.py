"""deepfm [arXiv:1703.04247]: 39 sparse fields, embed 10, MLP 400-400-400,
FM interaction.  Vocab 2^20 rows/field (criteo-hashed scale).  The port's
copy of ``repro/configs/deepfm.py``; SHAPES are the reference's
dry-run cells, which ``launch/cells.py`` builds."""
from repro_torch.models.recsys_models import DeepFMConfig

FAMILY = "recsys"
OPTIMIZER = "adam"

FULL = DeepFMConfig(name="deepfm", n_sparse=39, embed_dim=10,
                    vocab=1_048_576, mlp_dims=(400, 400, 400))
SMOKE = DeepFMConfig(name="deepfm-smoke", n_sparse=5, embed_dim=4,
                     vocab=64, mlp_dims=(16, 16))

SHAPES = {
    "train_batch": dict(kind="recsys_train", batch=65_536),
    "serve_p99": dict(kind="recsys_serve", batch=512),
    "serve_bulk": dict(kind="recsys_serve", batch=262_144),
    "retrieval_cand": dict(kind="recsys_retrieval", batch=1,
                           n_candidates=1_048_576),
}
SKIP = {}
