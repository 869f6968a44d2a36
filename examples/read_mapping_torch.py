"""End-to-end genome analysis on the GPU with the PyTorch port: batched
SAGe_Write (banded-DP kernel, decode-kernel verify), then the store's
SAGe_ISP stream into the read mapper with exact-match pruning (the paper's
integration scenario: decompression feeds the analysis, an
in-storage-filter-style stage drops exact reads first), and the
exact-match filter over every block of the dataset.

  PYTHONPATH=src python examples/read_mapping_torch.py             # on the card
  PYTHONPATH=src python examples/read_mapping_torch.py --device cpu  # plain versions
"""

import argparse
import sys
import time

sys.path.insert(0, "src")

from repro_torch.core import SageStore
from repro_torch.core.decode_torch import reset_trace_counts, trace_counts
from repro_torch.genomics.filter_torch import filter_store_blocks
from repro_torch.genomics.mapper import map_store_reads
from repro_torch.genomics.synth import make_reference, sample_read_set


def main() -> None:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--device", default="cuda", help="cuda (default) or cpu")
    args = ap.parse_args()
    print(f"=== SAGe -> read-mapping pipeline (PyTorch port, {args.device}) ===")
    ref = make_reference(60_000, seed=21)
    rs = sample_read_set(ref, "illumina", depth=3, seed=22)
    store = SageStore(device=args.device)
    reset_trace_counts()
    t0 = time.time()
    store.write("mapping", rs, ref, token_target=16384)  # SAGe_Write, batched
    st = store.last_write_stats
    print(f"wrote {len(rs.reads)} reads in {time.time()-t0:.2f}s: {st['n_batch_mapped']} batch-mapped, "
          f"{st['n_fallback']} by the per-read mapper, {st['n_escaped']} escaped; "
          f"launches {trace_counts()}")
    session = store.session()

    t0 = time.time()
    out = session.read("mapping")  # whole-file SAGe_Read (warms the decoder)
    n_decoded = int(out["n_reads"].sum())
    print(f"decoded {n_decoded} reads in {time.time()-t0:.2f}s")

    masks, pruned, total = filter_store_blocks(session, "mapping")
    print(f"exact-match filter over {masks.shape[0]} blocks: {pruned}/{total} forward reads are exact")

    # SAGe_ISP: stream decoded blocks into the mapper; reads whose decode
    # already carries an exact match position skip the expensive mapper
    # (GenStore-EM-style pruning)
    t0 = time.time()
    rep = map_store_reads(session, "mapping", ref, blocks_per_fetch=1)
    dt = time.time() - t0
    print(f"filter pruned {rep.pruned}/{rep.total} reads ({rep.pruned/rep.total:.0%}) — "
          f"mapper handled {rep.mapped}, unmapped {rep.unmapped}, in {dt:.1f}s")
    assert rep.total == n_decoded == total == len(rs.reads)
    assert rep.pruned >= pruned
    assert rep.pruned + rep.mapped > 0.9 * rep.total


if __name__ == "__main__":
    main()
