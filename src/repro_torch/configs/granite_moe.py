"""granite-moe-3b-a800m [moe]: every layer MoE, 40 experts top-8,
expert d_ff=512 [hf:ibm-granite/granite-3.0-1b-a400m-base scaled per the
assignment]. 32L, d_model=1536, 24 heads / 8 KV heads, vocab=49155.
Experts are padded to a multiple of the expert-parallel axis at dry-run
time (DESIGN.md §6)."""
from .base import ArchConfig

CONFIG = ArchConfig(
    name="granite-moe-3b-a800m",
    family="moe",
    n_layers=32,
    d_model=1536,
    n_heads=24,
    n_kv_heads=8,
    d_ff=512,
    moe_d_ff=512,
    vocab=49155,
    moe_experts=40,
    moe_top_k=8,
    moe_every=1,
    source="hf:ibm-granite/granite-3.0-1b-a400m-base",
)
