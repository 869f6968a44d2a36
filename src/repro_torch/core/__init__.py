"""SAGe core in PyTorch: container format, encoder, device decoders and the
session-based streaming store (the port of ``src/repro/core``)."""

from repro_torch.core.api import (
    FormatSpec,
    OutputFormat,
    apply_format,
    available_formats,
    get_format,
    kmer_pack,
    kmer_special_ids,
    kmer_vocab_size,
    one_hot_bases,
    pick_k,
    register_format,
    sage_read,
    sage_write,
)
from repro_torch.core.decode_torch import (
    PAD_BASE,
    DeviceBlocks,
    bucket_size,
    decode_block_arrays,
    decode_blocks_bucketed,
    pad_block_ids,
    prepare_device_blocks,
    reset_trace_counts,
    trace_counts,
)
from repro_torch.core.encoder import SageEncoder
from repro_torch.core.errors import (
    DEFAULT_RETRY,
    IntegrityError,
    RetryPolicy,
    SageIOError,
    StaleDatasetError,
    TornWriteError,
    TransientIOError,
)
from repro_torch.core.format import BlockCaps, SageFile, SageMeta
from repro_torch.core.layout import (
    HostExtentCache,
    SageContainerV2,
    container_version,
    open_container,
    write_v2,
)
from repro_torch.core.store import SageReadSession, SageStore, StreamBatch, slice_device_blocks
