"""llama3-405b [dense] [arXiv:2407.21783]: 126L, d_model=16384,
128 heads / 8 KV heads (head_dim 128), d_ff=53248, vocab=128256,
rope_theta=500000."""
from .base import ArchConfig

CONFIG = ArchConfig(
    name="llama3-405b",
    family="dense",
    n_layers=126,
    d_model=16384,
    n_heads=128,
    n_kv_heads=8,
    head_dim=128,
    d_ff=53248,
    vocab=128256,
    rope_theta=500000.0,
    source="arXiv:2407.21783",
)
