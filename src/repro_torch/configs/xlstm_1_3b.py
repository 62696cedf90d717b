"""xlstm-1.3b [ssm]: mLSTM + sLSTM blocks, xLSTM[7:1] cadence
[arXiv:2405.04517]. 48 blocks, d_model=2048, 4 heads, vocab=50304, no
separate FFN (d_ff=0; the mLSTM block has its own up/down projection,
factor 2)."""
from .base import ArchConfig

CONFIG = ArchConfig(
    name="xlstm-1.3b",
    family="ssm",
    n_layers=48,
    d_model=2048,
    n_heads=4,
    n_kv_heads=4,
    d_ff=0,
    vocab=50304,
    ssm_expand=2,
    slstm_every=8,           # one sLSTM per 8 blocks (7:1)
    rope=False,
    source="arXiv:2405.04517",
)
