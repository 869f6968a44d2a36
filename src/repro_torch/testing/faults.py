"""Fault injection for the SAGe storage path — the chaos harness.

Two complementary attack surfaces:

**In-flight faults** (``FaultPlan`` + ``inject``): every read-side file
open in :mod:`repro_torch.core.layout` routes through ``layout._open_read`` —
``inject(plan)`` swaps that seam for one returning :class:`FaultyFile`
wrappers, so reads can raise EIO, come up short, arrive slowly, or return
bit-flipped bytes *without the on-disk container ever being wrong*. Plan
counters are shared across re-opens, so "fail the 3rd read" means the 3rd
read **globally** — retries that re-open the file keep consuming the same
fault schedule, which is exactly how a flaky device behaves.

**At-rest faults** (``flip_bit``/``truncate_file``/``corrupt_extent``/
``corrupt_group``): deterministic damage to container bytes on disk —
persistent corruption the checksum layer must detect on every read until
the file is repaired. ``flip_bit`` returns an undo callable so benchmarks
can corrupt/measure/restore without copying multi-GB containers.

Nothing here is imported by production code; production exposes only the
``_open_read`` seam. This is the port's own seam: the JAX package's
``inject`` patches ``repro.core.layout`` and reaches nothing here, while
the at-rest helpers of either package flip the same file bytes."""

from __future__ import annotations

import dataclasses
import errno
import time
from contextlib import contextmanager
from pathlib import Path
from typing import Callable, Optional


@dataclasses.dataclass
class FaultPlan:
    """Schedule of in-flight read faults, indexed by GLOBAL read number.

    Read ``i`` (0-based, counted across every file opened through the
    injected seam, surviving re-opens) misbehaves when:

      - ``i in eio_reads`` or ``eio_every`` divides ``i+1`` → ``OSError``
        with ``errno.EIO`` (the retry path's bread and butter)
      - ``i in short_reads`` → returns only half the requested bytes
        (a torn/interrupted transfer)
      - ``flip_offsets`` maps a file byte offset to an XOR mask: any read
        covering that offset returns flipped bytes; each offset flips at
        most ``flip_times`` reads (default: every read — persistent
        in-flight corruption; ``flip_times=1`` = one transient flip that
        heals on the re-read)
      - ``slow_s`` > 0 → every read sleeps first (latency injection)

    ``paths`` restricts injection to those file paths (None = all).
    Counters (``reads``, ``eio_raised``, ``shorts``, ``flips``,
    ``slow_sleeps``) record what actually fired."""

    eio_reads: frozenset = frozenset()
    eio_every: Optional[int] = None
    short_reads: frozenset = frozenset()
    flip_offsets: dict = dataclasses.field(default_factory=dict)
    flip_times: Optional[int] = None
    slow_s: float = 0.0
    paths: Optional[frozenset] = None

    # shared live counters (survive re-opens by design)
    reads: int = 0
    eio_raised: int = 0
    shorts: int = 0
    flips: int = 0
    slow_sleeps: int = 0
    _flip_fired: dict = dataclasses.field(default_factory=dict)

    def applies_to(self, path) -> bool:
        return self.paths is None or str(path) in self.paths

    def next_read(self) -> int:
        i = self.reads
        self.reads += 1
        return i

    def mangle(self, pos: int, data: bytes, idx: int) -> bytes:
        """Apply the plan to the bytes of read ``idx`` at file ``pos``."""
        if idx in self.short_reads:
            self.shorts += 1
            data = data[: len(data) // 2]
        if self.flip_offsets:
            buf = None
            for off, mask in self.flip_offsets.items():
                if not (pos <= off < pos + len(data)):
                    continue
                fired = self._flip_fired.get(off, 0)
                if self.flip_times is not None and fired >= self.flip_times:
                    continue
                self._flip_fired[off] = fired + 1
                self.flips += 1
                if buf is None:
                    buf = bytearray(data)
                buf[off - pos] ^= mask
            if buf is not None:
                data = bytes(buf)
        return data

    def should_eio(self, idx: int) -> bool:
        if idx in self.eio_reads:
            return True
        return self.eio_every is not None and (idx + 1) % self.eio_every == 0


class FaultyFile:
    """A binary-read file wrapper that executes a :class:`FaultPlan`.

    Usable anywhere a ``with open(path, "rb") as f`` handle is — which is
    why ``layout._open_read`` is the seam: seek/tell/close pass through,
    ``read`` consults the plan."""

    def __init__(self, path, plan: FaultPlan) -> None:
        self._f = open(path, "rb")
        self._plan = plan
        self.path = path

    def read(self, n: int = -1) -> bytes:
        plan = self._plan
        idx = plan.next_read()
        if plan.slow_s > 0:
            plan.slow_sleeps += 1
            time.sleep(plan.slow_s)
        if plan.should_eio(idx):
            plan.eio_raised += 1
            raise OSError(errno.EIO, f"injected EIO on read {idx}")
        pos = self._f.tell()
        return plan.mangle(pos, self._f.read(n), idx)

    def seek(self, offset: int, whence: int = 0) -> int:
        return self._f.seek(offset, whence)

    def tell(self) -> int:
        return self._f.tell()

    def close(self) -> None:
        self._f.close()

    def __enter__(self) -> "FaultyFile":
        return self

    def __exit__(self, *exc) -> None:
        self.close()


@contextmanager
def inject(plan: FaultPlan):
    """Patch ``repro_torch.core.layout._open_read`` so every container read-open
    inside the block goes through ``plan``. Restores the seam on exit,
    even when the block raises. Yields the plan (counters live)."""
    from repro_torch.core import layout

    real = layout._open_read

    def faulty_open(path):
        if plan.applies_to(path):
            return FaultyFile(path, plan)
        return real(path)

    layout._open_read = faulty_open
    try:
        yield plan
    finally:
        layout._open_read = real


# ---------------------------------------------------------------- at rest
def flip_bit(path, offset: int, bit: int = 0) -> Callable[[], None]:
    """XOR one bit of the file in place; returns an undo callable (the
    same flip — XOR is its own inverse), so large containers never need a
    pristine copy."""
    path = Path(path)

    def flip() -> None:
        with open(path, "r+b") as f:
            f.seek(offset)
            b = f.read(1)
            f.seek(offset)
            f.write(bytes([b[0] ^ (1 << bit)]))

    flip()
    return flip


def truncate_file(path, nbytes: int) -> None:
    """Cut the file to ``nbytes`` — a torn write / interrupted copy."""
    with open(path, "r+b") as f:
        f.truncate(nbytes)


def corrupt_extent(path, block: int, *, byte: int = 0, bit: int = 0) -> Callable[[], None]:
    """Flip one bit inside block ``block``'s extent payload of a (valid)
    v2 container; returns the undo callable."""
    from repro_torch.core.layout import SageContainerV2

    c = SageContainerV2.open(path)
    # codec extents are payload-sized: wrap the offset into the STORED
    # length so the flip always lands in bytes a read actually touches
    # (never the alignment pad, where it would be a harmless no-op)
    off = int(c.extents[block, 0]) + byte % int(c.extents[block, 1])
    return flip_bit(path, off, bit)


def corrupt_group(path, group: int, group_blocks: int, **kw) -> Callable[[], None]:
    """Corrupt the first block of residency group ``group`` (as grouped by
    a ``SageStore(group_blocks=...)``); returns the undo callable."""
    return corrupt_extent(path, group * group_blocks, **kw)


def corrupt_extents(
    path, blocks, *, byte: int = 0, bit: int = 0
) -> Callable[[], None]:
    """Flip one payload bit in EACH of ``blocks`` — multi-extent damage in
    one shot (the unrecoverable-beyond-parity scenario when the blocks
    share a parity group). Returns a single undo restoring all of them."""
    undos = [corrupt_extent(path, int(b), byte=byte, bit=bit) for b in blocks]

    def undo() -> None:
        for u in undos:
            u()

    return undo


def corrupt_parity(
    path, group: int, shard: int = 0, *, byte: int = 0, bit: int = 0
) -> Callable[[], None]:
    """Flip one bit inside parity shard ``shard`` of PARITY group ``group``
    (container ``parity_group`` granularity, not store residency groups) of
    a v2 parity container; returns the undo callable. Damaged parity must
    be detected by scrub (and rebuilt from the data), never silently used
    for a reconstruction."""
    from repro_torch.core.layout import SageContainerV2

    c = SageContainerV2.open(path)
    if c.parity is None:
        raise ValueError(f"{path}: container has no parity section")
    m = int(c.parity["shards"])
    if not 0 <= shard < m:
        raise ValueError(f"parity shard {shard} out of range (container has {m})")
    p = int(group) * m + int(shard)
    off = c.parity_extent(p)[0] + byte
    return flip_bit(path, off, bit)
