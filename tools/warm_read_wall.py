"""Host-clock wall of warm 256-block SAGe_Read calls, repeated, for a
checkout of this repository, and where the host spends a fused read.

    python3 tools/warm_read_wall.py [--root DIR] [--windows N]

DIR (default: this checkout) is a checkout of the repository: its
chip_smoke.py and src/ are imported, so two commits compare on one card by
running this once for each, in turn (DIR: an older commit unpacked with
`git archive` under build/). The data are chip_smoke.py's full-width
Illumina blocks (C = 65558) tiled to 512 blocks in a codec container under
DIR/build/warm_read_wall, served by one SageStore of DIR's port. After a
cold read, N windows of two-step and of fused kmer reads (k = 4) alternate:
chip_smoke's WARM_READS reads of one 256-block range a window, timed on the
host clock from the first call to a synchronize after the last. Then N
fused reads are timed in two host parts, `store.prepared_for` (the gather
of the covering groups' rows) and the decode call (B5's wrapper), each
without a synchronize: the host's issue time. Prints one JSON line with
every window, the medians and the card. Needs a CUDA card.
"""

from __future__ import annotations

import argparse
import json
import shutil
import statistics
import sys
import time
from pathlib import Path

ROOT = Path(__file__).resolve().parents[1]


def main() -> None:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--root", type=Path, default=ROOT, help="checkout to measure")
    ap.add_argument("--windows", type=int, default=15)
    args = ap.parse_args()
    root = args.root.resolve()
    sys.path.insert(0, str(root))
    import chip_smoke as cs  # puts root/src first on sys.path

    torch = cs.torch
    if not torch.cuda.is_available():
        raise SystemExit("warm_read_wall: needs a CUDA card")
    ill = cs.ILLUMINA
    ref_seq = cs.make_reference(ill["ref_len"], seed=ill["ref_seed"])
    src = cs.SageEncoder(ref_seq, token_target=ill["token_target"]).encode(
        cs.sample_read_set(ref_seq, "illumina", depth=ill["depth"], seed=ill["seed"]))
    work = root / "build" / "warm_read_wall"
    shutil.rmtree(work, ignore_errors=True)
    work.mkdir(parents=True)
    cs.write_v2(cs.tile_sage_file(src, 64), work / "illumina.sage2")
    store = cs.SageStore(max_prepared=16, group_blocks=cs.GROUP)
    store.register("illumina", str(work / "illumina.sage2"))
    sessions = {"two_step": store.session(), "fused": store.session(fused=True)}
    rng = (7 * cs.GROUP, 7 * cs.GROUP + cs.BUCKET)

    def window(sess) -> float:
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        for _ in range(cs.WARM_READS):
            sess.read("illumina", rng, "kmer", kmer_k=cs.KMER_K)
        torch.cuda.synchronize()
        return (time.perf_counter() - t0) * 1e3

    for sess in sessions.values():
        window(sess)  # the cold read, then warm-up
    walls = {k: [] for k in sessions}
    for _ in range(args.windows):
        for k, sess in sessions.items():
            walls[k].append(window(sess))
    fused = sessions["fused"]
    ids = fused.resolve_blocks("illumina", rng)
    host = {"prepared_for": [], "decode_call": []}
    for _ in range(args.windows):
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        db, local = store.prepared_for("illumina", ids)
        t1 = time.perf_counter()
        fused._decode_prepared("illumina", db, local, "kmer", cs.KMER_K)
        t2 = time.perf_counter()
        host["prepared_for"].append((t1 - t0) * 1e3)
        host["decode_call"].append((t2 - t1) * 1e3)
        torch.cuda.synchronize()
    shutil.rmtree(work)
    med = lambda d: {k: statistics.median(v) for k, v in d.items()}  # noqa: E731
    print(json.dumps({"root": str(root), "reads_a_window": cs.WARM_READS, "window_ms": walls,
                      "window_median_ms": med(walls), "fused_read_host_ms": host,
                      "fused_read_host_median_ms": med(host), "card": cs.smi()}), flush=True)


if __name__ == "__main__":
    main()
