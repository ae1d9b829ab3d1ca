"""granite-3-8b [hf:ibm-granite]: 40L d4096 32H GQA(kv8) ff12800 — SwiGLU,
full attention.  Vocab 49155 padded to 49664 (multiple of 512) for mesh
divisibility; the pad rows are dead weights (noted in DESIGN.md).

The port's copy of ``repro/configs/granite_3_8b.py``:
SHAPES are the reference's cells, which ``launch/analytic.py`` prices."""
from repro_torch.models.transformer import TransformerConfig

FAMILY = "lm"
OPTIMIZER = "adam"
VOCAB_REAL = 49155

FULL = TransformerConfig(
    name="granite-3-8b", n_layers=40, d_model=4096, n_heads=32,
    n_kv_heads=8, d_ff=12800, vocab=49664, activation="swiglu",
    attn_type="full")

SMOKE = TransformerConfig(
    name="granite-3-8b-smoke", n_layers=2, d_model=64, n_heads=4,
    n_kv_heads=2, d_ff=192, vocab=128, activation="swiglu",
    attn_type="full", dtype="float32")

SHAPES = {
    "train_4k": dict(kind="train", seq_len=4096, global_batch=256,
                     microbatches=4),
    "prefill_32k": dict(kind="prefill", seq_len=32768, global_batch=32),
    "decode_32k": dict(kind="decode", seq_len=32768, global_batch=128),
}
SKIP = {"long_500k": "pure full attention — no sub-quadratic path "
                     "(DESIGN.md §5)"}
