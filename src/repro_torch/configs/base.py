"""Architecture config: the port's own copy of ``repro.configs.base``.

The fields and ``reduced()`` match the reference field for field, so a
reduced config here has the same shapes as the reference's reduced config.
``get_config`` knows every architecture of the reference.
"""
from __future__ import annotations

import dataclasses
import importlib
from dataclasses import dataclass
from typing import Dict, Tuple


@dataclass(frozen=True)
class ArchConfig:
    name: str
    family: str                     # dense | moe | ssm | hybrid | vlm | audio
    n_layers: int
    d_model: int
    n_heads: int
    n_kv_heads: int
    d_ff: int
    vocab: int
    head_dim: int = 0               # 0 -> d_model // n_heads

    # --- MoE ----------------------------------------------------------
    moe_experts: int = 0
    moe_top_k: int = 0
    moe_every: int = 1
    moe_d_ff: int = 0
    moe_shared_expert: bool = False
    moe_pad_to: int = 0
    moe_capacity_factor: float = 1.25
    moe_dispatch: str = "einsum"

    # --- SSM / hybrid / xLSTM ------------------------------------------
    ssm_state: int = 0
    ssm_heads: int = 0
    ssm_conv: int = 4
    ssm_expand: int = 2
    attn_every: int = 0
    slstm_every: int = 0

    # --- positions / attention variants ---------------------------------
    rope: bool = True
    rope_theta: float = 10000.0
    mrope_sections: Tuple[int, ...] = ()   # qwen2-vl M-RoPE (t, h, w)
    sliding_window: int = 0         # 0 = full causal attention
    qkv_bias: bool = False

    # --- encoder-decoder (whisper) --------------------------------------
    encoder_layers: int = 0
    encoder_seq: int = 0
    is_encoder_decoder: bool = False

    # --- VLM stub --------------------------------------------------------
    vision_tokens: int = 0          # prefix length of stubbed patch embeds

    norm_eps: float = 1e-5
    tie_embeddings: bool = False
    dtype: str = "bfloat16"
    source: str = ""                # citation

    def __post_init__(self):
        if self.head_dim == 0:
            object.__setattr__(self, "head_dim",
                               self.d_model // max(1, self.n_heads))

    @property
    def d_inner(self) -> int:
        return self.ssm_expand * self.d_model

    @property
    def n_ssm_heads(self) -> int:
        return self.ssm_heads or max(1, self.d_inner // 64)

    def pattern_unit(self) -> int:
        """Layers per stacked unit (heterogeneous layer patterns are
        grouped into repeating units)."""
        if self.family == "moe" and self.moe_every > 1:
            return self.moe_every
        if self.family == "hybrid" and self.attn_every > 0:
            return self.attn_every
        if self.slstm_every > 0:
            return self.slstm_every
        return 1

    @property
    def n_units(self) -> int:
        u = self.pattern_unit()
        if self.n_layers % u:
            raise ValueError(f"{self.name}: {self.n_layers} layers do not "
                             f"divide into units of {u}")
        return self.n_layers // u

    def reduced(self) -> "ArchConfig":
        """Smoke-test variant: same family/pattern, tiny dims (identical
        to the reference's ``reduced()``)."""
        u = self.pattern_unit()
        d = min(self.d_model, 256)
        heads = min(self.n_heads, 4)
        kv = min(self.n_kv_heads, heads)
        hd = max(16, d // heads)
        if self.mrope_sections:
            # keep the 1:1.5:1.5 t/h/w split, resized to hd//2 channels
            t = hd // 8
            h = (hd // 2 - t) // 2
            sections = (hd // 2 - 2 * h, h, h)
        else:
            sections = ()
        return dataclasses.replace(
            self,
            name=self.name + "-reduced",
            n_layers=max(u, 2 if u == 1 else u),
            d_model=d,
            n_heads=heads,
            n_kv_heads=kv,
            head_dim=hd,
            d_ff=min(self.d_ff, 512) or self.d_ff,
            moe_d_ff=min(self.moe_d_ff, 256) if self.moe_d_ff else 0,
            vocab=min(self.vocab, 1024),
            mrope_sections=sections,
            moe_experts=min(self.moe_experts, 4),
            moe_top_k=min(self.moe_top_k, 2) if self.moe_top_k else 0,
            ssm_state=min(self.ssm_state, 16) if self.ssm_state else 0,
            ssm_heads=min(self.n_ssm_heads, 4) if self.ssm_state else 0,
            encoder_layers=min(self.encoder_layers, 2),
            encoder_seq=min(self.encoder_seq, 64) if self.encoder_seq else 0,
            vision_tokens=min(self.vision_tokens, 16) if self.vision_tokens else 0,
            sliding_window=min(self.sliding_window, 64) if self.sliding_window else 0,
        )


_REGISTRY: Dict[str, str] = {
    "glm4-9b": "repro_torch.configs.glm4_9b",
    "granite-moe-3b-a800m": "repro_torch.configs.granite_moe",
    "llama3-405b": "repro_torch.configs.llama3_405b",
    "llama4-maverick-400b-a17b": "repro_torch.configs.llama4_maverick",
    "minicpm-2b": "repro_torch.configs.minicpm_2b",
    "qwen2-vl-2b": "repro_torch.configs.qwen2_vl_2b",
    "stablelm-12b": "repro_torch.configs.stablelm_12b",
    "whisper-tiny": "repro_torch.configs.whisper_tiny",
    "xlstm-1.3b": "repro_torch.configs.xlstm_1_3b",
    "zamba2-7b": "repro_torch.configs.zamba2_7b",
}

ARCH_NAMES = tuple(sorted(_REGISTRY))


def get_config(name: str) -> ArchConfig:
    if name not in _REGISTRY:
        raise KeyError(f"unknown arch {name!r}; known: {ARCH_NAMES}")
    return importlib.import_module(_REGISTRY[name]).CONFIG
