"""qwen2-vl-72b: M-RoPE decoder backbone; patch frontend stubbed [arXiv:2409.12191]."""
from repro_torch.configs.base import ArchConfig

CONFIG = ArchConfig(
    name="qwen2-vl-72b", family="vlm",
    n_layers=80, d_model=8192, n_heads=64, n_kv_heads=8, head_dim=128,
    d_ff=29568, vocab=152064,
    qkv_bias=True, mrope=True, mrope_sections=(16, 24, 24), img_frac=0.25,
    rope_theta=1_000_000.0,
)
