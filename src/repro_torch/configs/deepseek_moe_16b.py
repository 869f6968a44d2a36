"""deepseek-moe-16b: fine-grained MoE, 2 shared + 64 routed top-6 [arXiv:2401.06066]."""
from repro_torch.configs.base import ArchConfig

CONFIG = ArchConfig(
    name="deepseek-moe-16b", family="moe",
    n_layers=28, d_model=2048, n_heads=16, n_kv_heads=16, head_dim=128,
    d_ff=1408, expert_d_ff=1408, vocab=102400,
    n_experts=64, n_shared_experts=2, moe_top_k=6,
    rope_theta=10_000.0,
)
