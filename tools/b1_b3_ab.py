"""B1 (codec unpack) and B3 (k-mer pack) of two checkouts in turns on one
card, and B1 against a copy of it that stages each payload row in shared
memory.

    python3 tools/b1_b3_ab.py [--parent DIR] [--rounds N]

Data, made once by this checkout under build/b1_b3_ab/: chip_smoke.py's
Illumina set (120 kbp, depth 4, token_target 65536: 8 blocks of C = 65558)
in a codec v2 container. B1's input is one 32-extent group (the 8 stored
payloads 4x, chip_smoke's GROUP), B3's a 256-row bucket (the 8 blocks'
decoded tokens 32x) with their n_tokens, at k = 4: chip_smoke's shapes.

Each side runs in a process of its own that imports its checkout's
chip_smoke.py and port (and builds its kernels into that checkout's
build/): with --parent DIR (an older commit unpacked with `git archive`
under build/) the order is parent, change, change, parent; without it this
checkout alone. A side checks both kernels bit for bit against their plain
versions and times them N rounds with chip_smoke's `cuda_ms` (device ms
behind a spin kernel, and the host-paced call ms), beside the launch floor
(`torch.cuda._sleep(1)` timed the same way).

This checkout's side also builds a copy of csrc/sage_unpack.cu under
build/b1_b3_ab/staged/ in which each CTA holds one extent, a warp per
stream, and copies the payload row into shared memory behind one
__syncthreads before decoding from there; it is launched through the same
wrapper code and timed against the kept kernel in turns (kept, staged,
staged, kept) for N rounds. A patch point that moved stops the tool.

Prints one JSON line per side and a summary line with the medians and the
card. Needs a CUDA card.
"""

from __future__ import annotations

import argparse
import json
import shutil
import statistics
import subprocess
import sys
from pathlib import Path

import numpy as np

ROOT = Path(__file__).resolve().parents[1]
WORK = ROOT / "build" / "b1_b3_ab"
KMER_K = 4
SRC_BLOCKS, GROUP, BUCKET = 8, 32, 256
# (kept line, staged replacement) of sage_unpack.cu
STAGING_PATCH = [
    ("__launch_bounds__(32 * WARPS) sage_unpack_kernel",
     "__launch_bounds__(32 * MAX_STREAMS) sage_unpack_kernel"),
    ("  const uint32_t* row = p.packed + (long long)b * cap;  // read in place (L1 / L2)\n",
     "  SAGE_SMEM(uint32_t, row_s);\n"
     "  for (int i = threadIdx.x; i < cap; i += blockDim.x) row_s[i] = p.packed[(long long)b * cap + i];\n"
     "  __syncthreads();\n"
     "  const uint32_t* row = row_s;\n"),
    ("  sage_unpack_plan(p->n, p->ns, plan);\n",
     "  plan[0] = p->n;\n  plan[1] = 32 * p->ns;\n  plan[2] = p->cap * 4;\n"),
]


def make_data(path: Path) -> None:
    sys.path.insert(0, str(ROOT))
    import chip_smoke as cs

    torch = cs.torch
    ill = cs.ILLUMINA
    ref_seq = cs.make_reference(ill["ref_len"], seed=ill["ref_seed"])
    src = cs.SageEncoder(ref_seq, token_target=ill["token_target"]).encode(
        cs.sample_read_set(ref_seq, "illumina", depth=ill["depth"], seed=ill["seed"]))
    assert src.meta.n_blocks == SRC_BLOCKS, src.meta.n_blocks
    cs.write_v2(src, path.with_suffix(".sage2"))
    rdr = cs.SageContainerV2.open(path.with_suffix(".sage2"))
    ids = np.arange(SRC_BLOCKS)
    packed = np.asarray(rdr.gather_packed(ids)).view(np.int32)
    dicts = np.asarray(rdr._codec_dicts, np.uint8)
    widths = tuple((s, int(dict(rdr.layout.widths)[s])) for s in cs.STREAMS)
    dev = torch.device("cuda")
    arrays = dict(cs.ops.unpack(torch.as_tensor(packed, device=dev), torch.as_tensor(dicts, device=dev), widths))
    arrays["cons"] = cs.host_to_tensor(rdr.gather_consensus_windows(ids), dev)
    arrays["dir"] = cs.host_to_tensor(cs.localize_directory(rdr.directory, ids), dev)
    db = cs.DeviceBlocks(arrays, src.meta.caps, src.meta.classes, src.meta.fixed_read_len, SRC_BLOCKS, dev)
    tokens = cs.ops.sage_decode(db)["tokens"].cpu().numpy()
    np.savez(path, packed=np.tile(packed, (GROUP // SRC_BLOCKS, 1)), dicts=dicts,
             widths=np.array([w for _s, w in widths]), tokens=np.tile(tokens, (BUCKET // SRC_BLOCKS, 1)),
             n_tokens=np.tile(rdr.directory[ids, cs.D["n_tokens"]].astype(np.int32), BUCKET // SRC_BLOCKS))


def staged_lib(cs, log: dict):
    """Build the staging copy of sage_unpack.cu with the port's flags."""
    import ctypes

    out = WORK / "staged"
    shutil.rmtree(out, ignore_errors=True)
    out.mkdir(parents=True)
    csrc = ROOT / "src" / "repro_torch" / "kernels" / "csrc"
    shutil.copy(csrc / "sage_common.cuh", out)
    text = (csrc / "sage_unpack.cu").read_text()
    for old, new in STAGING_PATCH:
        if text.count(old) != 1:
            raise SystemExit(f"b1_b3_ab: patch point moved in sage_unpack.cu: {old!r}")
        text = text.replace(old, new)
    (out / "sage_unpack.cu").write_text(text)
    so = out / "libstaged.so"
    res = subprocess.run([cs.cuda_lib._nvcc(), *cs.cuda_lib.NVCC_FLAGS, "-I", str(out), "-o", str(so),
                          str(out / "sage_unpack.cu")], capture_output=True, text=True)
    if res.returncode:
        raise SystemExit(f"b1_b3_ab: nvcc failed for the staging copy:\n{res.stdout}{res.stderr}")
    log["staged_ptxas"] = [ln.strip() for ln in (res.stdout + res.stderr).splitlines() if "registers" in ln or "spill" in ln]
    from repro_torch.kernels import sage_decode as SD

    return SD.bind_unpack(ctypes.CDLL(str(so)))


def side(root: Path, data: Path, rounds: int, staged: bool) -> dict:
    sys.path.insert(0, str(root))
    import chip_smoke as cs  # puts root/src first on sys.path

    torch = cs.torch
    dev = torch.device("cuda")
    d = np.load(data)
    packed = torch.as_tensor(d["packed"], device=dev)
    dicts = torch.as_tensor(d["dicts"], device=dev)
    widths = tuple((s, int(w)) for s, w in zip(cs.STREAMS, d["widths"]))
    toks = torch.as_tensor(d["tokens"], device=dev)
    ntok = torch.as_tensor(d["n_tokens"], device=dev)
    cs.cuda_lib.build_all()
    got, want = cs.ops.unpack(packed, dicts, widths), cs.ref.sage_unpack_ref(packed, dicts, widths)
    km, km_ref = cs.ops.kmer_tokens(toks, KMER_K, ntok), cs.ref.kmer_pack_ref(toks, KMER_K, ntok)
    torch.cuda.synchronize()
    out = {"root": str(root), "card": cs.smi(),
           "b1_max_abs_err": max(cs.max_abs_err(got[s], want[s]) for s, _ in widths),
           "b3_max_abs_err": cs.max_abs_err(km, km_ref),
           "b1_ms": [], "b1_call_ms": [], "b3_ms": [], "b3_call_ms": [], "floor_ms": []}
    for _ in range(rounds):
        for key, fn, iters in (("b1", lambda: cs.ops.unpack(packed, dicts, widths), 200),
                               ("b3", lambda: cs.ops.kmer_tokens(toks, KMER_K, ntok), 50)):
            ms, call = cs.cuda_ms(fn, iters)
            out[f"{key}_ms"].append(ms)
            out[f"{key}_call_ms"].append(call)
        out["floor_ms"].append(cs.cuda_ms(lambda: torch.cuda._sleep(1), 200)[0])
    if staged:
        from repro_torch.kernels import sage_decode as SD

        libs = {"kept": SD._unpack_lib(), "staged": staged_lib(cs, out)}
        n = packed.shape[0]
        stream = torch.cuda.current_stream().cuda_stream

        def run(lib):
            buf = torch.empty(n * sum(w for _s, w in widths), dtype=torch.int32, device=dev)
            outs = [o.view(n, w) for o, (_s, w) in zip(buf.split([n * w for _s, w in widths]), widths)]
            rc = SD.launch_unpack(lib, packed, dicts, outs, stream)
            assert rc == 0, rc
            return outs

        for name, lib in libs.items():
            outs = run(lib)
            torch.cuda.synchronize()
            out[f"{name}_max_abs_err"] = max(cs.max_abs_err(o, want[s]) for o, (s, _w) in zip(outs, widths))
            out[f"{name}_ms"] = []
        for _ in range(rounds):
            for name in ("kept", "staged", "staged", "kept"):
                out[f"{name}_ms"].append(cs.cuda_ms(lambda lib=libs[name]: run(lib), 200)[0])
    return out


def main() -> None:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--parent", type=Path, help="an older checkout to time in turns with this one")
    ap.add_argument("--rounds", type=int, default=5)
    ap.add_argument("--side", type=Path, help=argparse.SUPPRESS)
    ap.add_argument("--staged", action="store_true", help=argparse.SUPPRESS)
    args = ap.parse_args()
    data = WORK / "data.npz"
    if args.side:
        print(json.dumps(side(args.side.resolve(), data, args.rounds, args.staged)), flush=True)
        return
    WORK.mkdir(parents=True, exist_ok=True)
    make_data(data)
    order = [("parent", args.parent), ("change", ROOT), ("change", ROOT), ("parent", args.parent)] \
        if args.parent else [("change", ROOT)]
    sides: dict[str, list] = {}
    staged_done = False
    for name, root in order:
        cmd = [sys.executable, __file__, "--side", str(root.resolve()), "--rounds", str(args.rounds)]
        if name == "change" and not staged_done:
            cmd.append("--staged")
            staged_done = True
        res = subprocess.run(cmd, capture_output=True, text=True)
        if res.returncode:
            raise SystemExit(f"b1_b3_ab: {name} side failed:\n{res.stdout}\n{res.stderr}")
        line = json.loads(res.stdout.strip().splitlines()[-1])
        print(json.dumps({"side": name, **line}), flush=True)
        sides.setdefault(name, []).append(line)
    summary = {}
    for name, lines in sides.items():
        for key in ("b1_ms", "b1_call_ms", "b3_ms", "b3_call_ms", "floor_ms", "kept_ms", "staged_ms"):
            vals = [v for ln in lines for v in ln.get(key, [])]
            if vals:
                summary[f"{name}_{key}_median"] = statistics.median(vals)
    print(json.dumps({"summary": summary, "card": sides["change"][0]["card"]}))


if __name__ == "__main__":
    main()
