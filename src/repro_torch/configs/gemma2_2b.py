"""gemma2-2b [arXiv:2408.00118]: 26L d2304 8H GQA(kv4, d_head 256) ff9216
vocab 256000 — alternating local(4096)/global attention, logit softcaps.

The port's copy of ``repro/configs/gemma2_2b.py``:
SHAPES are the reference's cells, which ``launch/analytic.py`` prices."""
from repro_torch.models.transformer import TransformerConfig

FAMILY = "lm"
OPTIMIZER = "adam"

FULL = TransformerConfig(
    name="gemma2-2b", n_layers=26, d_model=2304, n_heads=8, n_kv_heads=4,
    d_head=256, d_ff=9216, vocab=256000, activation="gelu",
    attn_type="local_global", window=4096, attn_softcap=50.0,
    final_softcap=30.0)

SMOKE = TransformerConfig(
    name="gemma2-2b-smoke", n_layers=4, d_model=64, n_heads=4, n_kv_heads=2,
    d_head=16, d_ff=256, vocab=128, activation="gelu",
    attn_type="local_global", window=8, attn_softcap=50.0,
    final_softcap=30.0, dtype="float32")

SHAPES = {
    "train_4k": dict(kind="train", seq_len=4096, global_batch=256,
                     microbatches=4),
    "prefill_32k": dict(kind="prefill", seq_len=32768, global_batch=32),
    "decode_32k": dict(kind="decode", seq_len=32768, global_batch=128),
    # local layers attend over a 4096 window (compute-skipped banded
    # kernel) -> sub-quadratic share; global layers stream the cache.
    "long_500k": dict(kind="decode", seq_len=524288, global_batch=1),
}
SKIP = {}
