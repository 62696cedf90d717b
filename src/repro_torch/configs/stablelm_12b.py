"""stablelm-12b [dense] [hf:stabilityai/stablelm-2-12b]: 40L,
d_model=5120, 32 heads / 8 KV heads (head_dim 160), d_ff=13824,
vocab=100352."""
from .base import ArchConfig

CONFIG = ArchConfig(
    name="stablelm-12b",
    family="dense",
    n_layers=40,
    d_model=5120,
    n_heads=32,
    n_kv_heads=8,
    d_ff=13824,
    vocab=100352,
    source="hf:stabilityai/stablelm-2-1_6b",
)
