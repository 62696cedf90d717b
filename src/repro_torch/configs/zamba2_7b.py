"""zamba2-7b [hybrid]: Mamba2 backbone + ONE shared attention+MLP block
re-applied periodically (weights shared across applications), per Zamba2
[arXiv:2411.15242]. 81 Mamba2 layers, d_model=3584, shared block has 32
full-MHA heads (head_dim 112) and a 14336 MLP; ssm_state=64, 112 SSM heads
of 64. The shared block follows every 9 Mamba2 layers (81 % 6 != 0; the
cadence is a config choice of the reference)."""
from .base import ArchConfig

CONFIG = ArchConfig(
    name="zamba2-7b",
    family="hybrid",
    n_layers=81,
    d_model=3584,
    n_heads=32,
    n_kv_heads=32,
    d_ff=14336,
    vocab=32000,
    ssm_state=64,
    ssm_expand=2,
    ssm_heads=112,           # d_inner 7168 / head 64
    attn_every=9,
    rope=True,
    source="arXiv:2411.15242",
)
