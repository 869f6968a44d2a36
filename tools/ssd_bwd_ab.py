"""B6 backward (csrc/ssd_chunk_bwd.cu) of this checkout against a parent's, in
turns on one card.

    python3 tools/ssd_bwd_ab.py --parent DIR [--rounds N]

DIR is an older commit unpacked with `git archive` under build/. Each side's
kernel source is built with nvcc and the port's flags (kernels/cuda_lib.py)
into build/ssd_bwd_ab/<side>/, bound through the common C interface
(`ssd_bwd_launch`), checked against this checkout's ssd_intra_bwd_plain at a
bf16 and an f32 shape, then timed at chip_smoke.py's two train shapes (bf16 x)
with CUDA events over 20 launches behind a spin kernel, in turns (parent,
change, change, parent) for N rounds. Prints the median ms of each side and
shape with the card's name and power limit. Needs a CUDA card.
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
from repro_torch.kernels import cuda_lib  # noqa: E402
from repro_torch.kernels.ssd_chunk import ssd_intra_bwd_plain  # noqa: E402

SHAPES = {"mamba2": (8, 4, 128, 32, 64, 128), "zamba2": (8, 4, 128, 80, 64, 64)}
CHECKS = [((2, 2, 128, 4, 64, 128), torch.bfloat16), ((2, 3, 37, 3, 96, 200), torch.float32)]


def build(side: str, csrc: Path) -> ctypes.CDLL:
    d = ROOT / "build" / "ssd_bwd_ab" / side
    shutil.rmtree(d, ignore_errors=True)
    shutil.copytree(csrc, d)
    subprocess.run(["/usr/local/cuda/bin/nvcc", *cuda_lib.NVCC_FLAGS, "-I", str(d), "-o", str(d / "k.so"),
                    str(d / "ssd_chunk_bwd.cu")], check=True)
    lib = ctypes.CDLL(str(d / "k.so"))
    lib.ssd_bwd_launch.argtypes = ([ctypes.c_void_p, ctypes.c_int] + [ctypes.c_void_p] * 12
                                   + [ctypes.c_int] * 6 + [ctypes.c_void_p])
    return lib


def inputs(shape, dtype):
    Bb, nc, Q, H, P, N = shape
    g = torch.Generator(device="cuda").manual_seed(7)
    x = torch.randn((Bb, nc, Q, H, P), generator=g, device="cuda").to(dtype)
    dt = torch.nn.functional.softplus(torch.randn((Bb, nc, Q, H), generator=g, device="cuda"))
    a = dt * -torch.exp(torch.randn((H,), generator=g, device="cuda") * 0.3)
    B, C = (torch.randn((Bb, nc, Q, H, N), generator=g, device="cuda") * 0.3 for _ in range(2))
    dy = torch.randn((Bb, nc, Q, H, P), generator=g, device="cuda").to(dtype)
    return (x, dt, a, B, C, dy, torch.randn((Bb, nc, H, P, N), generator=g, device="cuda"),
            torch.randn((Bb, nc, H), generator=g, device="cuda"))


def launcher(lib, args):
    x, dt, a, B, C, dy, dst, dtot = args
    outs = [torch.empty_like(x), torch.empty_like(dt), torch.empty_like(dt), torch.empty_like(B), torch.empty_like(B)]
    ptrs = [x.data_ptr(), int(x.dtype == torch.bfloat16)] + [t.data_ptr() for t in (dt, a, B, C, dy, dst, dtot, *outs)]

    def run():
        rc = lib.ssd_bwd_launch(*ptrs, *x.shape, B.shape[-1], torch.cuda.current_stream().cuda_stream)
        if rc:
            raise RuntimeError(f"ssd_bwd_launch failed: {rc}")
    return run, outs


def matches(lib) -> bool:
    ok = True
    for shape, dtype in CHECKS:
        args = inputs(shape, dtype)
        run, got = launcher(lib, args)
        run()
        for u, v in zip(got, ssd_intra_bwd_plain(*args)):
            rtol = 8e-3 if u.dtype == torch.bfloat16 else 1e-5
            ok &= bool(torch.allclose(u.float(), v.float(), rtol=rtol, atol=1e-5 * float(v.float().abs().max())))
    return ok


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
        raise SystemExit("ssd_bwd_ab: no CUDA card")
    csrc = Path("src") / "repro_torch" / "kernels" / "csrc"
    libs = {"change": build("change", ROOT / csrc), "parent": build("parent", args.parent.resolve() / csrc)}
    checks = {side: matches(lib) for side, lib in libs.items()}
    runs = {shape: {side: launcher(lib, inputs(dims, torch.bfloat16))[0] for side, lib in libs.items()}
            for shape, dims in SHAPES.items()}
    times = {shape: {side: [] for side in libs} for shape in SHAPES}
    for _ in range(args.rounds):
        for shape in SHAPES:
            for side in ("parent", "change", "change", "parent"):
                times[shape][side].append(device_ms(runs[shape][side]))
    card = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
                          capture_output=True, text=True, check=True).stdout.strip().splitlines()[0]
    print(json.dumps({"times_ms": times, "checks": checks, "card": card,
                      "median_ms": {shape: {side: statistics.median(t) for side, t in v.items()}
                                    for shape, v in times.items()}}))


if __name__ == "__main__":
    main()
