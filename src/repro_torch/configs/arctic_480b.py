"""arctic-480b [moe] — 128 experts top-2 + dense residual
[hf:Snowflake/snowflake-arctic-base; hf]. Assumption: the dense residual
FFN uses the same hidden size as one expert (d_ff=4864)."""
from repro_torch.configs.base import ArchConfig, register

CONFIG = register(ArchConfig(
    name="arctic-480b", family="moe",
    n_layers=35, d_model=7168, n_heads=56, n_kv_heads=8,
    d_ff=4864, vocab=32000, head_dim=128, act="silu",
    n_experts=128, top_k=2, dense_residual=True,
))
