"""minicpm-2b [dense]: llama-like, trained with the WSD schedule
[arXiv:2404.06395]. 40L, d_model=2304, 36 heads (MHA), d_ff=5760,
vocab=122753, tied embeddings."""
from .base import ArchConfig

CONFIG = ArchConfig(
    name="minicpm-2b",
    family="dense",
    n_layers=40,
    d_model=2304,
    n_heads=36,
    n_kv_heads=36,
    d_ff=5760,
    vocab=122753,
    tie_embeddings=True,
    source="arXiv:2404.06395",
)
