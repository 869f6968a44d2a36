"""Test-support utilities shipped with the library (fault injection), the
port of ``src/repro/testing``: ``inject`` patches this package's read seam,
``repro_torch.core.layout._open_read``."""

from repro_torch.testing.faults import (
    FaultPlan,
    FaultyFile,
    corrupt_extent,
    corrupt_extents,
    corrupt_group,
    corrupt_parity,
    flip_bit,
    inject,
    truncate_file,
)

__all__ = [
    "FaultPlan",
    "FaultyFile",
    "corrupt_extent",
    "corrupt_extents",
    "corrupt_group",
    "corrupt_parity",
    "flip_bit",
    "inject",
    "truncate_file",
]
