"""bert4rec [arXiv:1904.06690]: embed 64, 2 blocks, 2 heads, seq 200,
bidirectional cloze training.  Catalogue 2^20 items; training uses
sampled softmax (1024 negatives) — full-vocab logits at batch 65536 x 200
positions would be ~50 TB.  Encoder-only: serve = next-item scoring.
The port's copy of ``repro/configs/bert4rec.py``; SHAPES are the
reference's dry-run cells, which ``launch/cells.py`` builds."""
from repro_torch.models.recsys_models import BERT4RecConfig

FAMILY = "recsys_seq"
OPTIMIZER = "adam"
N_NEGATIVES = 1024
N_MASKED = 20          # masked (cloze) positions per sequence

FULL = BERT4RecConfig(name="bert4rec", embed_dim=64, n_blocks=2, n_heads=2,
                      seq_len=200, n_items=1_048_576, d_ff=256)
SMOKE = BERT4RecConfig(name="bert4rec-smoke", embed_dim=16, n_blocks=2,
                       n_heads=2, seq_len=12, n_items=128, d_ff=32)

SHAPES = {
    "train_batch": dict(kind="seq_train", batch=65_536),
    "serve_p99": dict(kind="seq_serve", batch=512),
    "serve_bulk": dict(kind="seq_serve", batch=262_144),
    "retrieval_cand": dict(kind="seq_retrieval", batch=1,
                           n_candidates=1_048_576),
}
SKIP = {}
