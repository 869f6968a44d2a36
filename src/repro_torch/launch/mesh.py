"""Production mesh definitions (H100 clusters), the port of
``src/repro/launch/mesh.py``.

``make_production_mesh`` is a FUNCTION (never a module-level constant), so
importing this module touches no process group or device.
"""

from __future__ import annotations

import math


def make_mesh(shape: tuple[int, ...], axes: tuple[str, ...], *, device_type: str = "cuda"):
    """A ``DeviceMesh`` of ``shape`` with dimension names ``axes`` over the
    ranks of the default process group (tests, examples, elastic restarts);
    ``torch.distributed`` must be initialized with ``prod(shape)`` ranks."""
    from torch.distributed.device_mesh import init_device_mesh

    if len(shape) != len(axes):
        raise ValueError(f"mesh shape {shape} and axes {axes} differ in length")
    return init_device_mesh(device_type, tuple(shape), mesh_dim_names=tuple(axes))


def make_production_mesh(*, multi_pod: bool = False, device_type: str = "cuda"):
    """One pod: (data=16, model=16) = 256 ranks. Two pods: (pod=2,
    data=16, model=16) = 512 ranks. Raises ``ValueError`` naming the world
    size it needs when the process group has another size."""
    import torch.distributed as dist

    shape = (2, 16, 16) if multi_pod else (16, 16)
    axes = ("pod", "data", "model") if multi_pod else ("data", "model")
    need = math.prod(shape)
    have = dist.get_world_size() if dist.is_available() and dist.is_initialized() else 0
    if have != need:
        raise ValueError(
            f"the production mesh {dict(zip(axes, shape))} needs a process group of {need} ranks; "
            f"this process has {have or 'none'}"
        )
    return make_mesh(shape, axes, device_type=device_type)


# NVIDIA H100 SXM data-sheet rates (per card) for roofline estimates
H100_PEAK_FLOPS_BF16 = 989e12  # FLOP/s, dense bf16 tensor cores
H100_HBM_BYTES_PER_S = 3.35e12  # B/s, HBM3
H100_NVLINK_BYTES_PER_S = 450e9  # B/s each way (NVLink 4, 900 GB/s both ways), inside a node
#: GPUs an HGX / DGX H100 node joins by NVLink; ranks 8k..8k+7 share a node
H100_GPUS_PER_NODE = 8
#: B/s each way a GPU between nodes: one 400 Gb/s InfiniBand NDR port
#: (ConnectX-7) a GPU, as a DGX H100 has
H100_NODE_LINK_BYTES_PER_S = 50e9
