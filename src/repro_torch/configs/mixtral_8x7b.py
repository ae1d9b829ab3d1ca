"""mixtral-8x7b [arXiv:2401.04088]: 32L d4096 32H GQA(kv8) vocab 32000,
MoE 8 experts top-2 (d_ff 14336/expert), SWA window 4096.

8 experts < 16-way model axis, so expert weights use tensor-parallelism
*within* experts (d_ff sharded) instead of expert-parallelism — see the
reference's launch/shardings.py; kimi-k2 (384e) takes the EP path.

The port's copy of ``repro/configs/mixtral_8x7b.py``:
SHAPES are the reference's cells, which ``launch/analytic.py`` prices."""
from repro_torch.models.transformer import TransformerConfig

FAMILY = "lm"
OPTIMIZER = "adam"

FULL = TransformerConfig(
    name="mixtral-8x7b", n_layers=32, d_model=4096, n_heads=32,
    n_kv_heads=8, d_ff=14336, vocab=32000, activation="swiglu",
    attn_type="swa", window=4096, n_experts=8, top_k=2, moe_d_ff=14336)

SMOKE = TransformerConfig(
    name="mixtral-8x7b-smoke", n_layers=2, d_model=64, n_heads=4,
    n_kv_heads=2, d_ff=128, vocab=128, activation="swiglu",
    attn_type="swa", window=8, n_experts=4, top_k=2, moe_d_ff=128,
    dtype="float32")

SHAPES = {
    "train_4k": dict(kind="train", seq_len=4096, global_batch=256,
                     microbatches=8),
    "prefill_32k": dict(kind="prefill", seq_len=32768, global_batch=32),
    "decode_32k": dict(kind="decode", seq_len=32768, global_batch=128),
    # SWA caps every layer's attention window -> O(S*W) decode reads
    "long_500k": dict(kind="decode", seq_len=524288, global_batch=1),
}
SKIP = {}
