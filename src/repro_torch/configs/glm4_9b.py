"""glm4-9b [dense]: RoPE + aggressive GQA (2 KV heads) [hf:THUDM/glm-4-9b].
40L, d_model=4096, 32 heads / 2 KV heads, d_ff=13696, vocab=151552,
qkv bias."""
from .base import ArchConfig

CONFIG = ArchConfig(
    name="glm4-9b",
    family="dense",
    n_layers=40,
    d_model=4096,
    n_heads=32,
    n_kv_heads=2,
    d_ff=13696,
    vocab=151552,
    qkv_bias=True,
    source="hf:THUDM/glm-4-9b",
)
