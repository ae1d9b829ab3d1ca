"""nemotron-4-340b [arXiv:2402.16819]: 96L d18432 96H GQA(kv8) ff73728
vocab 256000 — squared-ReLU FFN, pure full attention.

The port's copy of ``repro/configs/nemotron_4_340b.py``:
SHAPES are the reference's cells, which ``launch/analytic.py`` prices."""
from repro_torch.models.transformer import TransformerConfig

FAMILY = "lm"
OPTIMIZER = "adafactor"          # 340B: Adam state would not fit 16 GiB chips

FULL = TransformerConfig(
    name="nemotron-4-340b", n_layers=96, d_model=18432, n_heads=96,
    n_kv_heads=8, d_ff=73728, vocab=256000, activation="squared_relu",
    attn_type="full")

SMOKE = TransformerConfig(
    name="nemotron-4-340b-smoke", n_layers=2, d_model=64, n_heads=4,
    n_kv_heads=2, d_ff=256, vocab=128, activation="squared_relu",
    attn_type="full", dtype="float32")

SHAPES = {
    "train_4k": dict(kind="train", seq_len=4096, global_batch=256,
                     microbatches=16),
    "prefill_32k": dict(kind="prefill", seq_len=32768, global_batch=32),
    "decode_32k": dict(kind="decode", seq_len=32768, global_batch=128),
}
SKIP = {"long_500k": "pure full attention — no sub-quadratic path "
                     "(DESIGN.md §5)"}
