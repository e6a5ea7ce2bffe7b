"""internvl2-76b [vlm] — InternViT frontend STUB (input_specs provides
patch embeddings) + InternLM2-style 80L backbone [arXiv:2404.16821]."""
from repro_torch.configs.base import ArchConfig, register

CONFIG = register(ArchConfig(
    name="internvl2-76b", family="vlm",
    n_layers=80, d_model=8192, n_heads=64, n_kv_heads=8,
    d_ff=28672, vocab=128256, head_dim=128, act="silu",
    n_patches=256,
))
