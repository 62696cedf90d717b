"""Plain reference of the vlm family (qwen2-vl-2b as the port runs it):
the dense family's blocks with GQA and M-RoPE, the first
``vision_tokens`` positions taking the row's vision-patch embeddings in
place of token embeddings (the vision tower is stubbed in the port and
here alike)."""
from .dense import row_loss  # noqa: F401
