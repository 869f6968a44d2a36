"""The banded-alignment DP kernel (csrc/banded_align.cu) of this checkout
against a parent's, in turns on one card.

    python3 tools/dp_ab.py --parent DIR [--rounds N]

DIR is an older commit unpacked with `git archive` under build/. Each side's
banded_align.cu is built with nvcc and the port's flags (kernels/cuda_lib.py)
into build/dp_ab/<side>/, bound through the common C interface
(`align_scan_launch`), checked bit for bit against this checkout's
align_scan_plain on every shape, then timed with CUDA events over 20 launches
behind a spin kernel, in turns (parent, change, change, parent) for N rounds,
at chip_smoke.py's DP chunk (1024 Illumina lanes, L 150, band 24: width 49)
and at tests/dp_cases.py's widths 289, 641 and 1023. Prints the median ms of
each side and shape with the card's name and power limit. Needs a CUDA card.
"""

from __future__ import annotations

import argparse
import ctypes
import json
import shutil
import statistics
import subprocess
import sys
from pathlib import Path

import torch

ROOT = Path(__file__).resolve().parents[1]
sys.path.insert(0, str(ROOT / "src"))
sys.path.insert(0, str(ROOT / "tests"))
sys.path.insert(0, str(ROOT))
from chip_smoke import DP_LANES, ILLUMINA, dp_lanes  # noqa: E402
from dp_cases import scan_inputs  # noqa: E402
from repro_torch.genomics.mapper import ReadMapper  # noqa: E402
from repro_torch.genomics.synth import make_reference, sample_read_set  # noqa: E402
from repro_torch.kernels import cuda_lib  # noqa: E402
from repro_torch.kernels.banded_align import align_scan_plain, dp_inputs  # noqa: E402

WIDE = {"w289": "l1200_b144", "w641": "l3000_b320", "w1023": "l600_b511"}


def build(side: str, csrc: Path) -> ctypes.CDLL:
    d = ROOT / "build" / "dp_ab" / side
    shutil.rmtree(d, ignore_errors=True)
    shutil.copytree(csrc, d)
    subprocess.run(["/usr/local/cuda/bin/nvcc", *cuda_lib.NVCC_FLAGS, "-I", str(d), "-o", str(d / "k.so"),
                    str(d / "banded_align.cu")], check=True)
    lib = ctypes.CDLL(str(d / "k.so"))
    lib.align_scan_launch.argtypes = [ctypes.c_void_p] * 6 + [ctypes.c_int] * 4 + [ctypes.c_void_p]
    return lib


def shapes() -> dict:
    """name -> ([reads, wins, off0, wlen] on the card, band)."""
    ref = make_reference(ILLUMINA["ref_len"], seed=ILLUMINA["ref_seed"])
    rs = sample_read_set(ref, "illumina", depth=ILLUMINA["depth"], seed=ILLUMINA["seed"])
    rows, cand, band = dp_lanes(rs.reads, ref, ReadMapper(ref))
    out = {"w49": ([torch.from_numpy(a).cuda() for a in dp_inputs(rows[:DP_LANES], ref, cand[:DP_LANES], band)],
                   band)}
    for name, case in WIDE.items():
        arrs, band = scan_inputs(case)
        out[name] = ([torch.from_numpy(a).cuda() for a in arrs], band)
    return out


def launcher(lib, args, band: int):
    reads, wins, off0, wlen = args
    B, L = reads.shape
    moves = torch.empty((B, L, 2 * band + 1), dtype=torch.uint8, device="cuda")
    last = torch.empty((B, 2 * band + 1), dtype=torch.int32, device="cuda")
    ptrs = [t.data_ptr() for t in (reads, wins, off0, wlen, moves, last)]

    def run():
        rc = lib.align_scan_launch(*ptrs, B, L, band, wins.shape[1], torch.cuda.current_stream().cuda_stream)
        if rc:
            raise RuntimeError(f"align_scan_launch failed: {rc}")
    return run, (moves, last)


def device_ms(run, iters: int = 20) -> float:
    for _ in range(3):
        run()
    torch.cuda.synchronize()
    s, e = torch.cuda.Event(enable_timing=True), torch.cuda.Event(enable_timing=True)
    torch.cuda._sleep(int(2e9 * 0.003 * iters))  # the stream waits while every launch is enqueued
    s.record()
    for _ in range(iters):
        run()
    e.record()
    torch.cuda.synchronize()
    return s.elapsed_time(e) / iters


def main() -> None:
    ap = argparse.ArgumentParser()
    ap.add_argument("--parent", type=Path, required=True)
    ap.add_argument("--rounds", type=int, default=3)
    args = ap.parse_args()
    if not torch.cuda.is_available():
        raise SystemExit("dp_ab: no CUDA card")
    csrc = Path("src") / "repro_torch" / "kernels" / "csrc"
    libs = {"change": build("change", ROOT / csrc), "parent": build("parent", args.parent.resolve() / csrc)}
    cases = shapes()
    runs, checks = {}, {}
    for name, (t, band) in cases.items():
        want = align_scan_plain(*t, band=band)
        runs[name] = {}
        for side, lib in libs.items():
            run, got = launcher(lib, t, band)
            run()
            torch.cuda.synchronize()
            checks[f"{name}/{side}"] = all(torch.equal(a, b) for a, b in zip(got, want))
            runs[name][side] = run
    times = {name: {side: [] for side in libs} for name in cases}
    for _ in range(args.rounds):
        for name in cases:
            for side in ("parent", "change", "change", "parent"):
                times[name][side].append(device_ms(runs[name][side]))
    card = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
                          capture_output=True, text=True, check=True).stdout.strip().splitlines()[0]
    med = {name: {side: statistics.median(t) for side, t in v.items()} for name, v in times.items()}
    print(json.dumps({"times_ms": times, "checks": checks, "card": card,
                      "shapes": {name: [*t[0].shape, 2 * band + 1] for name, (t, band) in cases.items()},
                      "median_ms": med,
                      "speedup": {name: m["parent"] / m["change"] for name, m in med.items()}}))


if __name__ == "__main__":
    main()
