"""llama4-maverick-400b-a17b [moe]: interleaved MoE every other layer
(24 MoE layers: 128 routed experts top-1 + 1 shared expert, expert
d_ff=8192; 24 dense layers d_ff=16384), GQA 8 KV heads, vocab=202048
[hf:meta-llama/Llama-4-Scout-17B-16E + Llama-4 model card]. The flat
reading (MoE in all 48 layers) would be ~770B params; interleaving lands
at ~0.4T, matching the name (DESIGN.md §6)."""
from .base import ArchConfig

CONFIG = ArchConfig(
    name="llama4-maverick-400b-a17b",
    family="moe",
    n_layers=48,
    d_model=5120,
    n_heads=40,
    n_kv_heads=8,
    head_dim=128,
    d_ff=16384,              # dense interleaved layers
    moe_d_ff=8192,           # routed + shared experts
    vocab=202048,
    moe_experts=128,
    moe_top_k=1,
    moe_every=2,
    moe_shared_expert=True,
    source="hf:meta-llama/Llama-4-Scout-17B-16E",
)
