"""Split the block-decode kernels' time into phases with clock64 stamps.

    python3 tools/decode_phase_split.py

Copies the CUDA sources of B2 / B5 (src/repro_torch/kernels/csrc) to
build/phase_split/, puts a CTA barrier and a clock64 stamp at the end of
each phase of the per-block body (decode_prefix, the row walk, the runs set
aside, emit, the read planes), builds the copy with the port's nvcc flags
and decodes one 256-lane bucket of chip_smoke.py's full-width Illumina
blocks (C = 65558) five times with B2 and with B5 in kmer (k = 4) and
onehot, launched on the copy through the wrapper's launchers. It prints one
JSON line per kernel: each phase's share of a block's SM cycles, the cycles
a block, and the card. The kept sources are not touched; a stamp point that
moved stops the tool. The stamps add barriers and atomics, so the shares,
not the absolute times, are the result. Needs a CUDA card.
"""

from __future__ import annotations

import ctypes
import json
import shutil
import subprocess
import sys
from pathlib import Path

import numpy as np

ROOT = Path(__file__).resolve().parents[1]
sys.path.insert(0, str(ROOT / "src"))

import torch  # noqa: E402

from repro_torch.core import decode_torch as DT  # noqa: E402
from repro_torch.core.blocks import pad_block_ids  # noqa: E402
from repro_torch.core.encoder import SageEncoder  # noqa: E402
from repro_torch.genomics.synth import make_reference, sample_read_set  # noqa: E402
from repro_torch.kernels import cuda_lib  # noqa: E402
from repro_torch.kernels import sage_decode as SD  # noqa: E402

CSRC = ROOT / "src" / "repro_torch" / "kernels" / "csrc"
OUT = ROOT / "build" / "phase_split"
LANES = 256
LAUNCHES = 5
KMER_K = 4
STAMP = """__device__ unsigned long long g_ph[16];
__device__ unsigned long long g_nblk;
#define STAMP(i) do { __syncthreads(); if (threadIdx.x == 0) { long long now_ = clock64(); \\
  atomicAdd(&g_ph[i], (unsigned long long)(now_ - t_last_)); t_last_ = now_; } } while (0)
"""
READ = """
extern "C" int probe_read(unsigned long long* out) {
  cudaMemcpyFromSymbol(out, g_ph, 16 * sizeof(unsigned long long));
  cudaMemcpyFromSymbol(out + 16, g_nblk, sizeof(unsigned long long));
  return (int)cudaDeviceSynchronize();
}
extern "C" int probe_reset() {
  unsigned long long z[16] = {0};
  cudaMemcpyToSymbol(g_ph, z, sizeof(z));
  cudaMemcpyToSymbol(g_nblk, z, sizeof(unsigned long long));
  return (int)cudaDeviceSynchronize();
}
"""
PHASES = ["per-segment / per-mismatch phases", "row walk", "runs set aside, token by token",
          "output walk + format", "read planes"]
# (file, old, new): each edit puts a stamp at the end of a phase; every
# `old` text must occur once
EDITS = [
    ("sage_decode_body.cuh", "namespace sage_decode {\n", STAMP + "namespace sage_decode {\n"),
    ("sage_decode_body.cuh", "                         int n_tok, const uint32_t* cw, int* sh) {",
     "                         int n_tok, const uint32_t* cw, int* sh, long long& t_last_) {"),
    ("sage_decode_body.cuh",
     "    if (!done) atomicOr(S.dmask + (a / RUN >> 5), 1u << ((a / RUN) & 31));\n  }\n  __syncthreads();",
     "    if (!done) atomicOr(S.dmask + (a / RUN >> 5), 1u << ((a / RUN) & 31));\n  }\n  STAMP(1);"),
    ("sage_decode_body.cuh",
     "               [&](int r) { row_run(p, S, sc, src, n_tok, cw, r * RUN); });\n  __syncthreads();",
     "               [&](int r) { row_run(p, S, sc, src, n_tok, cw, r * RUN); });\n  STAMP(2);"),
    ("sage_decode.cu",
     "    decode_prefix(p, S, sc, src, valid, cw, sh);\n    decode_row(p, S, sc, src, n_tok, cw, sh);\n"
     "    emit<FMT>(p, S, sc, b, n_tok);",
     "    long long t_last_ = clock64();\n    decode_prefix(p, S, sc, src, valid, cw, sh);\n    STAMP(0);\n"
     "    decode_row(p, S, sc, src, n_tok, cw, sh, t_last_);\n    emit<FMT>(p, S, sc, b, n_tok);\n    STAMP(3);"),
    ("sage_decode.cu", "    __syncthreads();  // the next lane reuses the CTA's arrays",
     "    STAMP(4);\n    if (threadIdx.x == 0) atomicAdd(&g_nblk, 1ull);"),
]


def stamped_lib() -> ctypes.CDLL:
    if OUT.exists():
        shutil.rmtree(OUT)
    shutil.copytree(CSRC, OUT / "csrc")
    for name, old, new in EDITS:
        path = OUT / "csrc" / name
        text = path.read_text()
        if text.count(old) != 1:
            raise SystemExit(f"{name}: a stamp point is not where this tool expects it: {old[:60]!r}")
        path.write_text(text.replace(old, new, 1))
    kern = OUT / "csrc" / "sage_decode.cu"
    kern.write_text(kern.read_text() + READ)
    log = subprocess.run([cuda_lib._nvcc(), *cuda_lib.NVCC_FLAGS, "-I", str(OUT / "csrc"), "-o",
                          str(OUT / "lib.so"), str(kern)], capture_output=True, text=True)
    if log.returncode:
        raise SystemExit(log.stdout + log.stderr)
    return ctypes.CDLL(str(OUT / "lib.so"))


def main() -> None:
    if not torch.cuda.is_available():
        raise SystemExit("decode_phase_split: needs a CUDA card")
    dev = torch.device("cuda")
    lib = stamped_lib()
    ref_seq = make_reference(120_000, seed=7)
    sf = SageEncoder(ref_seq, token_target=65536).encode(sample_read_set(ref_seq, "illumina", depth=4, seed=8))
    db = DT.prepare_device_blocks(sf).to(dev)
    ids, valid = pad_block_ids(np.arange(LANES) % db.n_blocks)
    R, _M, _I, _U, C = SD.decode_dims(db.caps)
    ins = {k: db.arrays[k] for k in list(SD.STREAMS) + ["cons", "dir"]}
    sub = DT.gather_lanes(db, ids, db.device, valid=valid)
    sub["valid"] = sub["valid"].to(torch.int32).contiguous()
    idv = torch.as_tensor(np.stack([ids.astype(np.int32), valid]), device=dev)
    kw = dict(caps=db.caps, classes=db.classes, fixed_len=db.fixed_len)

    def launcher(kernel: str, fmt: str):
        outs = {"tokens": torch.empty((LANES, C), dtype=torch.int8, device=dev)}
        outs.update({k: torch.empty((LANES, R), dtype=torch.int32, device=dev) for k in SD.OUT_KEYS[1:]})
        outs.update({k: torch.empty((LANES,), dtype=torch.int32, device=dev) for k in SD.FUSED_COUNT_KEYS})
        outs["kmer"] = torch.empty((LANES, C // KMER_K), dtype=torch.int32, device=dev)
        outs["onehot"] = torch.empty((LANES, C, 4), dtype=torch.bfloat16, device=dev)
        plan = SD.launch_plan(db.caps, ins["cons"].shape[1], LANES, kernel, dev)
        scratch = (torch.empty((plan["grid"], plan["slot_bytes"]), dtype=torch.uint8, device=dev)
                   if plan["slot_bytes"] else None)
        stream = torch.cuda.current_stream().cuda_stream
        if kernel == "decode":
            return lambda: SD.launch_decode(lib, sub, outs, scratch, plan["grid"], stream=stream, **kw)
        return lambda: SD.launch_fused(lib, ins, idv, outs, scratch, plan["grid"], fmt=fmt, kmer_k=KMER_K,
                                       stream=stream, **kw)

    runs = {"B2": launcher("decode", "2bit"), "B5 kmer": launcher("fused_kmer", "kmer"),
            "B5 onehot": launcher("fused_onehot", "onehot")}
    card = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
                          capture_output=True, text=True).stdout.strip()
    buf = (ctypes.c_ulonglong * 17)()
    for name, fn in runs.items():
        if fn():
            raise SystemExit(f"{name}: launch failed")
        torch.cuda.synchronize()
        lib.probe_reset()
        for _ in range(LAUNCHES):
            fn()
        lib.probe_read(buf)
        cycles = [buf[i] for i in range(len(PHASES))]
        blocks = max(int(buf[16]), 1)
        total = sum(cycles)
        print(json.dumps({"kernel": name, "blocks": blocks, "cycles_per_block": total / blocks,
                          "share": {n: c / total for n, c in zip(PHASES, cycles)},
                          "cycles_per_block_by_phase": {n: c / blocks for n, c in zip(PHASES, cycles)},
                          "card": card}), flush=True)


if __name__ == "__main__":
    main()
