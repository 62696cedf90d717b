"""The vlm family (qwen2-vl-2b as the port runs it): the dense family's
blocks with M-RoPE and GQA, over every position, the vision prefix's
included (its embeddings replace the token embeddings there). The FLOPs
and launches are the dense family's."""
from .dense import (LAYERED, attention_flops, attention_launches,  # noqa
                    block_params, flops_per_token, head_dim, ssd_launches)
