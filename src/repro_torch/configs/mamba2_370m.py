"""mamba2-370m: attention-free SSD (state-space duality) [arXiv:2405.21060]."""
from repro_torch.configs.base import ArchConfig

CONFIG = ArchConfig(
    name="mamba2-370m", family="ssm",
    n_layers=48, d_model=1024, n_heads=0, n_kv_heads=0, head_dim=0,
    d_ff=0, vocab=50280,
    ssm_state=128, ssm_headdim=64, d_inner=2048, ssm_groups=1, ssm_chunk=128,
    tie_embeddings=True,
)
