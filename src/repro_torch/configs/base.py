"""Architecture + shape configuration system (a copy of ``repro``'s, as data).

Every assigned architecture is a frozen :class:`ArchConfig`; the four
assigned input shapes are :data:`SHAPES`. ``reduced()`` derives the tiny
same-family config used by CPU tests. The fields are ``repro``'s, field for
field, so a configuration means the same in both packages; of the execution
fields the port reads ``dtype``, ``attn_impl``, ``attn_chunk``, ``remat``
and ``remat_policy`` (``models.module.run_periods``), and the dry run reads
the distribution context (``tp_size``, ``mesh_axes``: padded heads and the
activation specs). It loops over layers in Python, so ``scan_layers`` and
``unroll_loops`` change nothing, and applies no activation sharding.
"""
from __future__ import annotations

import dataclasses
from typing import Dict, Optional, Tuple


@dataclasses.dataclass(frozen=True)
class ShapeCfg:
    name: str
    seq_len: int
    global_batch: int
    kind: str  # "train" | "prefill" | "decode"


SHAPES: Dict[str, ShapeCfg] = {
    "train_4k": ShapeCfg("train_4k", 4096, 256, "train"),
    "prefill_32k": ShapeCfg("prefill_32k", 32768, 32, "prefill"),
    "decode_32k": ShapeCfg("decode_32k", 32768, 128, "decode"),
    "long_500k": ShapeCfg("long_500k", 524288, 1, "decode"),
}


@dataclasses.dataclass(frozen=True)
class ArchConfig:
    name: str
    family: str  # dense | moe | ssm | hybrid | encdec | vlm
    n_layers: int
    d_model: int
    n_heads: int
    n_kv_heads: int
    d_ff: int
    vocab: int
    head_dim: Optional[int] = None  # default d_model // n_heads
    act: str = "silu"  # silu (swiglu) | geglu | gelu
    norm: str = "rmsnorm"  # rmsnorm | layernorm
    rope_style: str = "standard"  # standard | partial | none
    rope_theta: float = 10000.0
    tie_embeddings: bool = False
    embed_scale: bool = False  # gemma: embeddings * sqrt(d)
    # MoE
    n_experts: int = 0
    top_k: int = 0
    capacity_factor: float = 1.25
    dense_residual: bool = False  # arctic: dense FFN in parallel with MoE
    # SSM (mamba2 / SSD)
    ssm_state: int = 0
    ssm_expand: int = 2
    ssm_headdim: int = 64
    ssm_groups: int = 1
    conv_kernel: int = 4
    ssm_chunk: int = 256
    # hybrid (recurrentgemma: RG-LRU + local attention, pattern cycling)
    window: int = 0
    block_pattern: Tuple[str, ...] = ()  # e.g. ("rec", "rec", "attn")
    lru_width: Optional[int] = None
    # encoder-decoder (whisper): encoder depth + stub frontend frames
    n_enc_layers: int = 0
    enc_frames: int = 1500
    # vlm (internvl2): stub patch embeddings prepended to the text sequence
    n_patches: int = 0
    # numerics / execution
    dtype: str = "bfloat16"
    remat: bool = True
    remat_policy: str = "full"  # full | dots (save matmul outputs) | none
    scan_layers: bool = True
    attn_impl: str = "auto"  # auto | full | chunked | pallas
    attn_chunk: int = 1024
    unroll_loops: bool = False  # cost-probe mode: python loops, exact FLOPs
    # --- distribution context (set by the launcher via dataclasses.replace;
    # defaults give single-device semantics for smoke tests) ---
    tp_size: int = 1  # size of the "model" mesh axis
    shard_acts: bool = False  # emit with_sharding_constraint on activations
    seq_shard_acts: bool = True  # sequence-parallel residual stream (SP)
    microbatches: int = 1  # gradient-accumulation steps per train_step
    mesh_axes: Tuple[Tuple[str, int], ...] = ()  # (("data",16),("model",16))
    # sub-quadratic decode? (controls long_500k applicability)
    @property
    def subquadratic(self) -> bool:
        return self.family in ("ssm", "hybrid")

    @property
    def hd(self) -> int:
        return self.head_dim if self.head_dim else self.d_model // self.n_heads

    # ---- attention sharding mode (derived from tp_size) -------------------
    # "head":       n_heads divides the model axis -> Megatron head sharding
    # "padded":     pad heads to the next multiple (overhead <= 34%) so the
    #               padded heads shard; zero wq/wo rows keep the math exact
    # "replicated": attention replicated over the model axis (tiny models
    #               where padding would cost too much, e.g. gemma's 8 heads)
    @property
    def attn_mode(self) -> str:
        if self.tp_size <= 1 or self.n_heads == 0:
            return "none"
        if self.n_heads % self.tp_size == 0:
            return "head"
        hp = -(-self.n_heads // self.tp_size) * self.tp_size
        return "padded" if hp / self.n_heads <= 1.34 else "replicated"

    @property
    def padded_heads(self) -> int:
        if self.attn_mode == "padded":
            return -(-self.n_heads // self.tp_size) * self.tp_size
        return self.n_heads

    def kv_head_map(self):
        """Static map padded-head-index -> kv-head-index (GQA repeat)."""
        import numpy as np
        rep = max(self.n_heads // max(self.n_kv_heads, 1), 1)
        idx = np.minimum(np.arange(self.padded_heads) // rep,
                         max(self.n_kv_heads, 1) - 1)
        return idx.astype(np.int32)

    def supports(self, shape: ShapeCfg) -> bool:
        if shape.name == "long_500k" and not self.subquadratic:
            return False  # assignment spec: skip for pure full-attention archs
        return True

    def reduced(self) -> "ArchConfig":
        """Tiny same-family config for CPU smoke tests."""
        return dataclasses.replace(
            self,
            n_layers=min(self.n_layers, 2 if not self.block_pattern
                         else len(self.block_pattern)),
            d_model=64,
            n_heads=4,
            n_kv_heads=min(self.n_kv_heads, 2) if self.n_kv_heads > 1 else 1,
            d_ff=128,
            vocab=256,
            head_dim=16 if self.head_dim else None,
            n_experts=min(self.n_experts, 4) if self.n_experts else 0,
            top_k=min(self.top_k, 2) if self.top_k else 0,
            ssm_state=16 if self.ssm_state else 0,
            ssm_headdim=16 if self.ssm_state else 64,
            ssm_chunk=8,
            window=16 if self.window else 0,
            lru_width=None,
            n_enc_layers=min(self.n_enc_layers, 2),
            enc_frames=24 if self.n_enc_layers else 1500,
            n_patches=8 if self.n_patches else 0,
            dtype="float32",
            remat=False,
            attn_chunk=16,
        )


_REGISTRY: Dict[str, ArchConfig] = {}


def register(cfg: ArchConfig) -> ArchConfig:
    _REGISTRY[cfg.name] = cfg
    return cfg


def get_config(name: str) -> ArchConfig:
    import repro_torch.configs  # noqa: F401  (triggers registration)
    if name not in _REGISTRY:
        raise KeyError(f"unknown arch '{name}'; have {sorted(_REGISTRY)}")
    return _REGISTRY[name]


def list_configs() -> Tuple[str, ...]:
    import repro_torch.configs  # noqa: F401
    return tuple(sorted(_REGISTRY))
