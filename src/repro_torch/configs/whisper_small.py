"""whisper-small: enc-dec backbone; conv frontend stubbed [arXiv:2212.04356]."""
from repro_torch.configs.base import ArchConfig

CONFIG = ArchConfig(
    name="whisper-small", family="encdec",
    n_layers=12, n_enc_layers=12, d_model=768, n_heads=12, n_kv_heads=12,
    head_dim=64, d_ff=3072, vocab=51865,
    act="gelu", gated_mlp=False, learned_pos=True, n_frames_max=1500,
    norm_eps=1e-5,
)
