"""chatglm3-6b [dense] — RoPE 2d (partial rotary), GQA [arXiv:2406.12793; hf]."""
from repro_torch.configs.base import ArchConfig, register

CONFIG = register(ArchConfig(
    name="chatglm3-6b", family="dense",
    n_layers=28, d_model=4096, n_heads=32, n_kv_heads=2,
    d_ff=13696, vocab=65024, act="silu", rope_style="partial",
))
