"""kimi-k2-1t-a32b [arXiv:2501.kimi2, paper-table]: 61L d7168 64H GQA(kv8)
vocab 163840, MoE 384 experts top-8 (d_ff 2048/expert) + 1 shared expert.
~1T total / ~32B active params.  Adafactor (factored second moments) —
Adam state for 1T params cannot fit 16 GiB/chip x 512.

The port's copy of ``repro/configs/kimi_k2_1t_a32b.py``:
SHAPES are the reference's cells, which ``launch/analytic.py`` prices."""
from repro_torch.models.transformer import TransformerConfig

FAMILY = "lm"
OPTIMIZER = "adafactor"

FULL = TransformerConfig(
    name="kimi-k2-1t-a32b", n_layers=61, d_model=7168, n_heads=64,
    n_kv_heads=8, d_ff=2048, vocab=163840, activation="swiglu",
    attn_type="full", n_experts=384, top_k=8, moe_d_ff=2048,
    shared_experts=1)

SMOKE = TransformerConfig(
    name="kimi-k2-smoke", n_layers=2, d_model=64, n_heads=4, n_kv_heads=2,
    d_ff=64, vocab=128, activation="swiglu", attn_type="full",
    n_experts=8, top_k=2, moe_d_ff=64, shared_experts=1, dtype="float32")

SHAPES = {
    "train_4k": dict(kind="train", seq_len=4096, global_batch=256,
                     microbatches=8),
    "prefill_32k": dict(kind="prefill", seq_len=32768, global_batch=32),
    "decode_32k": dict(kind="decode", seq_len=32768, global_batch=128),
}
SKIP = {"long_500k": "full attention per the assigned config — no "
                     "sub-quadratic path (DESIGN.md §5)"}
