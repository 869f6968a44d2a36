"""Migrate SAGe containers between on-disk layouts — and heal them (the
port of ``tools/migrate_container.py``, on this package's container code).

v1 (monolithic ``.npz``, whole-file decompress on every open) -> v2
(block-extent container: header + one alignment-padded extent per block,
lazy ranged reads — see DESIGN.md §7), and back for compatibility.

  PYTHONPATH=src python -m repro_torch.tools.migrate_container reads.sage.npz reads.sage2
  PYTHONPATH=src python -m repro_torch.tools.migrate_container reads.sage2 back.sage.npz --to-v1
  PYTHONPATH=src python -m repro_torch.tools.migrate_container in out --verify  # bit-identity

Self-healing (DESIGN.md §10):

  # re-write with a parity section (xor = 1 shard/group, rs = m shards)
  python -m repro_torch.tools.migrate_container reads.sage2 prot.sage2 --add-parity xor
  python -m repro_torch.tools.migrate_container reads.sage2 prot.sage2 --add-parity rs \\
      --parity-group 16 --parity-shards 2
  # scan + reconstruct + rewrite damaged extents of a parity container
  # IN PLACE (atomic tmp + fsync + rename); exits non-zero when damage
  # exceeds the parity budget
  python -m repro_torch.tools.migrate_container damaged.sage2 --repair

``--verify`` re-opens the migrated container, materializes it, and diffs
every section (meta, directory, consensus, all 14 streams) against the
source — exits non-zero on any mismatch. On v2 output this drives the full
checksum layer (header CRCs, per-extent CRC32C, commit footer), so a
corrupted or torn output also fails verify, printing the failing section.

``--legacy`` writes the pre-checksum v2 layout (no CRC section, no commit
footer) — for readers that predate the integrity format.

Compression (DESIGN.md §11): v2 output is codec-compressed by default —
per-extent word truncation + nibble dictionaries, compact binary
directory/extent tables, payload-sized slots. ``--recompress`` makes that
intent explicit for v2 -> v2 migrations (re-encoding an old raw container
shrinks it by orders of magnitude; old containers keep reading
bit-identically without migration). ``--no-codec`` (implied by
``--legacy``) writes the raw stride-aligned layout instead.
"""

from __future__ import annotations

import argparse
import os
import sys

from repro_torch.core.errors import SageIOError
from repro_torch.core.format import SageFile
from repro_torch.core.layout import (
    DEFAULT_ALIGN,
    SageContainerV2,
    container_version,
    write_v2,
)


def _load_any(path: str) -> SageFile:
    if container_version(path) == 2:
        return SageContainerV2.open(path).to_sage_file()
    return SageFile.load(path)


def repair_in_place(path: str) -> int:
    """Scan every extent + parity shard of ``path``, reconstruct what
    parity can fix, and atomically rewrite it. Returns a process exit
    code; unrecoverable damage prints the typed error and fails."""
    c = SageContainerV2.open(path)
    bad = c.verify_blocks()
    if bad:
        try:
            rebuilt = c.reconstruct_blocks(bad)
        except SageIOError as e:
            print(f"REPAIR FAILED: {type(e).__name__}: {e}", file=sys.stderr)
            return 1
        c.rewrite_extents(rebuilt)
        print(f"repaired {len(rebuilt)} damaged extent(s): {sorted(rebuilt)}")
    # parity second: its recompute reads the (now clean) data extents
    bad_parity = c.verify_parity()
    if bad_parity:
        try:
            fixed = c.rebuild_parity(bad_parity)
        except SageIOError as e:
            print(f"REPAIR FAILED: {type(e).__name__}: {e}", file=sys.stderr)
            return 1
        c.rewrite_extents({}, fixed)
        print(f"rebuilt {len(fixed)} damaged parity shard(s): {sorted(fixed)}")
    if not bad and not bad_parity:
        print(f"{path}: clean — nothing to repair")
        return 0
    # fresh handle: prove the medium verifies end-to-end before reporting ok
    fresh = SageContainerV2.open(path)
    still = fresh.verify_blocks() + fresh.verify_parity()
    if still:
        print(f"REPAIR FAILED: re-verify still finds damage: {still}",
              file=sys.stderr)
        return 1
    print(f"{path}: repaired and re-verified clean")
    return 0


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__)
    ap.add_argument("src", help="source container (v1 .npz or v2)")
    ap.add_argument("dst", nargs="?", default=None,
                    help="destination path (omitted for --repair, which is in place)")
    ap.add_argument("--to-v1", action="store_true",
                    help="write a v1 .npz instead of a v2 block-extent container")
    ap.add_argument("--align", type=int, default=None,
                    help="v2 extent alignment in bytes (default: the codec's "
                         f"small alignment, or {DEFAULT_ALIGN} with --no-codec)")
    ap.add_argument("--recompress", action="store_true",
                    help="re-encode every extent with the per-extent codec "
                         "(explicit form of the v2 default; rejects --no-codec)")
    ap.add_argument("--no-codec", action="store_true",
                    help="write the raw stride-aligned v2 layout instead of "
                         "codec-compressed extents")
    ap.add_argument("--verify", action="store_true",
                    help="re-open the output and check section-by-section bit-identity "
                         "(on v2 output this also runs the checksum layer)")
    ap.add_argument("--legacy", action="store_true",
                    help="write the pre-checksum v2 layout (no CRCs, no commit footer)")
    ap.add_argument("--add-parity", nargs="?", const="xor", default=None,
                    choices=("xor", "rs"), metavar="SCHEME",
                    help="write a self-healing v2 container: parity over every "
                         "--parity-group extents (default scheme: xor)")
    ap.add_argument("--parity-group", type=int, default=16,
                    help="extents per parity group (default 16)")
    ap.add_argument("--parity-shards", type=int, default=2,
                    help="parity shards per group for --add-parity rs (default 2)")
    ap.add_argument("--repair", action="store_true",
                    help="scan SRC for damage, reconstruct from parity, and "
                         "atomically rewrite it in place (no dst)")
    args = ap.parse_args(argv)

    if args.repair:
        if args.dst is not None or args.to_v1 or args.add_parity:
            ap.error("--repair is in place: give only the container path")
        return repair_in_place(args.src)
    if args.dst is None:
        ap.error("dst is required (unless --repair)")
    if args.add_parity and (args.to_v1 or args.legacy):
        ap.error("--add-parity needs the checksummed v2 layout "
                 "(drop --to-v1/--legacy)")
    if args.recompress and (args.no_codec or args.to_v1 or args.legacy):
        ap.error("--recompress writes codec-compressed v2 extents "
                 "(drop --no-codec/--to-v1/--legacy)")
    codec = not (args.no_codec or args.legacy)

    sf = _load_any(args.src)
    if args.to_v1:
        sf.save(args.dst)
        print(f"v1 <- {args.src}: {sf.meta.n_blocks} blocks, "
              f"{os.path.getsize(args.dst)/1e6:.2f} MB -> {args.dst}")
    else:
        stats = write_v2(sf, args.dst, align=args.align,
                         integrity=not args.legacy,
                         parity=args.add_parity,
                         parity_group=args.parity_group,
                         parity_shards=args.parity_shards,
                         codec=codec)
        parity_note = (
            f", parity {stats['parity']} x{stats['parity_shards']}/"
            f"{stats['parity_group']} (+{100 * stats['parity_overhead']:.1f}%)"
            if stats["parity"] else ""
        )
        if stats["codec"]:
            raw = stats["n_blocks"] * stats["payload_nbytes"]
            stored = stats["stored_payload_nbytes"]
            extent_note = (
                f"codec extents ({stored/1e6:.2f} MB stored / "
                f"{raw/1e6:.2f} MB decoded = {raw/max(stored, 1):.1f}x"
                + (f", {stats['dedup_blocks']} deduped"
                   if stats["dedup_blocks"] else "")
                + ")"
            )
        else:
            extent_note = (
                f"{stats['stride_nbytes']} B raw extents "
                f"(payload {stats['payload_nbytes']} B)"
            )
        print(f"v2 <- {args.src}: {stats['n_blocks']} blocks x "
              f"{extent_note}, "
              f"header {stats['header_nbytes']/1e3:.1f} KB"
              f"{' (legacy, unchecksummed)' if args.legacy else ''}{parity_note}, "
              f"total {stats['file_nbytes']/1e6:.2f} MB -> {args.dst}")

    if args.verify:
        try:
            probs = _load_any(args.dst).diff(sf)
        except SageIOError as e:
            section = e.section or "unknown section"
            print(f"VERIFY FAILED: {type(e).__name__} in {section}: {e}",
                  file=sys.stderr)
            return 1
        if probs:
            print(f"VERIFY FAILED: sections differ: {probs}", file=sys.stderr)
            return 1
        print("verify: bit-identical round trip")
    return 0


if __name__ == "__main__":
    sys.exit(main())
