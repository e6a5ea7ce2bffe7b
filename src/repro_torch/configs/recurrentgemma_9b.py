"""recurrentgemma-9b [hybrid] — RG-LRU + local attention, pattern
(rec, rec, attn) cycling over 38 layers [arXiv:2402.19427]."""
from repro_torch.configs.base import ArchConfig, register

CONFIG = register(ArchConfig(
    name="recurrentgemma-9b", family="hybrid",
    n_layers=38, d_model=4096, n_heads=16, n_kv_heads=1,
    d_ff=12288, vocab=256000, head_dim=256, act="geglu",
    window=2048, block_pattern=("rec", "rec", "attn"),
    embed_scale=True, tie_embeddings=True,
))
