"""zamba2-2.7b: Mamba2 backbone + shared attention block [arXiv:2411.15242]."""
from repro_torch.configs.base import ArchConfig

CONFIG = ArchConfig(
    name="zamba2-2.7b", family="hybrid",
    n_layers=54, d_model=2560, n_heads=32, n_kv_heads=32, head_dim=80,
    d_ff=10240, vocab=32000,
    ssm_state=64, ssm_headdim=64, d_inner=5120, ssm_groups=1, ssm_chunk=128,
    attn_every=6, rope_theta=10_000.0,
)
