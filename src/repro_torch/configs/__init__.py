from repro_torch.configs.base import SHAPES, ArchConfig, ShapeCell
from repro_torch.configs.registry import ARCHS, cells, get_arch, get_shape
