"""whisper-tiny [audio]: encoder-decoder [arXiv:2212.04356]. 4 encoder +
4 decoder layers, d_model=384, 6 heads (MHA), d_ff=1536, vocab=51865.
The mel-spectrogram and conv frontend is stubbed: a batch carries
(batch, 1500, d_model) frame embeddings. Sinusoidal positions."""
from .base import ArchConfig

CONFIG = ArchConfig(
    name="whisper-tiny",
    family="audio",
    n_layers=4,              # decoder layers
    d_model=384,
    n_heads=6,
    n_kv_heads=6,
    d_ff=1536,
    vocab=51865,
    encoder_layers=4,
    encoder_seq=1500,
    is_encoder_decoder=True,
    rope=False,
    source="arXiv:2212.04356",
)
