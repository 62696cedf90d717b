"""qwen2-vl-2b [vlm]: text decoder with M-RoPE (t/h/w sections) and a
stubbed vision tower [arXiv:2409.12191]. 28L, d_model=1536, 12 heads /
2 KV heads (head_dim 128), d_ff=8960, vocab=151936. The batch supplies
precomputed patch embeddings for the first ``vision_tokens`` positions."""
from .base import ArchConfig

CONFIG = ArchConfig(
    name="qwen2-vl-2b",
    family="vlm",
    n_layers=28,
    d_model=1536,
    n_heads=12,
    n_kv_heads=2,
    head_dim=128,
    d_ff=8960,
    vocab=151936,
    mrope_sections=(16, 24, 24),   # sums to head_dim/2
    vision_tokens=1024,
    tie_embeddings=True,
    source="arXiv:2409.12191",
)
