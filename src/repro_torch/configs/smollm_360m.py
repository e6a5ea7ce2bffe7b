"""smollm-360m [dense] — llama-arch small [hf:HuggingFaceTB/SmolLM-135M; hf]."""
from repro_torch.configs.base import ArchConfig, register

CONFIG = register(ArchConfig(
    name="smollm-360m", family="dense",
    n_layers=32, d_model=960, n_heads=15, n_kv_heads=5,
    d_ff=2560, vocab=49152, act="silu", tie_embeddings=True,
))
