"""minitron-8b: pruned nemotron; squared-ReLU non-gated MLP [arXiv:2407.14679]."""
from repro_torch.configs.base import ArchConfig

CONFIG = ArchConfig(
    name="minitron-8b", family="dense",
    n_layers=32, d_model=4096, n_heads=32, n_kv_heads=8, head_dim=128,
    d_ff=16384, vocab=256000,
    act="relu2", gated_mlp=False, rope_theta=10_000.0,
)
