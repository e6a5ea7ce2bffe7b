"""whisper-small [audio] — enc-dec backbone; conv frontend is a STUB:
input_specs() provides precomputed frame embeddings [arXiv:2212.04356]."""
from repro_torch.configs.base import ArchConfig, register

CONFIG = register(ArchConfig(
    name="whisper-small", family="encdec",
    n_layers=12, d_model=768, n_heads=12, n_kv_heads=12,
    d_ff=3072, vocab=51865, act="gelu", norm="layernorm",
    rope_style="none", n_enc_layers=12, enc_frames=1500,
))
