"""Architecture registry: --arch <id> resolution."""
from repro_torch.configs.base import SHAPES, ArchConfig, ShapeCell
from repro_torch.configs.deepseek_moe_16b import CONFIG as deepseek_moe_16b
from repro_torch.configs.moonshot_v1_16b_a3b import CONFIG as moonshot_v1_16b_a3b
from repro_torch.configs.qwen2_1_5b import CONFIG as qwen2_1_5b
from repro_torch.configs.minitron_8b import CONFIG as minitron_8b
from repro_torch.configs.yi_34b import CONFIG as yi_34b
from repro_torch.configs.yi_9b import CONFIG as yi_9b
from repro_torch.configs.zamba2_2_7b import CONFIG as zamba2_2_7b
from repro_torch.configs.qwen2_vl_72b import CONFIG as qwen2_vl_72b
from repro_torch.configs.mamba2_370m import CONFIG as mamba2_370m
from repro_torch.configs.whisper_small import CONFIG as whisper_small

ARCHS: dict[str, ArchConfig] = {
    c.name: c
    for c in (
        deepseek_moe_16b, moonshot_v1_16b_a3b, qwen2_1_5b, minitron_8b,
        yi_34b, yi_9b, zamba2_2_7b, qwen2_vl_72b, mamba2_370m, whisper_small,
    )
}


def get_arch(name: str) -> ArchConfig:
    if name not in ARCHS:
        raise KeyError(f"unknown arch {name!r}; known: {sorted(ARCHS)}")
    return ARCHS[name]


def get_shape(name: str) -> ShapeCell:
    return SHAPES[name]


def cells(include_skipped: bool = False):
    """All (arch, shape) cells; skips long_500k for full-attention archs."""
    out = []
    for a in ARCHS.values():
        for s in SHAPES.values():
            skip = s.name == "long_500k" and not a.sub_quadratic
            if include_skipped or not skip:
                out.append((a, s, skip))
    return out
