"""moonshot-v1-16b-a3b (kimi/moonlight): MoE 64e top-6 [hf:moonshotai/Moonlight-16B-A3B]."""
from repro_torch.configs.base import ArchConfig

CONFIG = ArchConfig(
    name="moonshot-v1-16b-a3b", family="moe",
    n_layers=48, d_model=2048, n_heads=16, n_kv_heads=16, head_dim=128,
    d_ff=1408, expert_d_ff=1408, vocab=163840,
    n_experts=64, n_shared_experts=2, moe_top_k=6,
    rope_theta=50_000.0,
)
