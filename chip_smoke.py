"""Smoke run of the PyTorch/CUDA port on one NVIDIA GPU: SAGe_Write (batched),
SAGe_Read, SAGe_ISP (streams, the exact-match filter, the store-backed
mapper), the LM token pipeline, mamba2-370m serving store-derived prompts,
the multi-tenant SageServer frontend, the self-healing store (parity
reconstruction, scrub, repair), mamba2-370m trained on SAGe k-mer tokens
with checkpoints, and qwen2-1.5b (dense), zamba2-2.7b (hybrid) and
deepseek-moe-16b (moe, cut in depth) served and trained at full width,
through the hand-written CUDA kernels,
checked against the sequential numpy encoder and decoder, the plain torch
versions and the CPU.

    python3 chip_smoke.py

Phases, each printing one JSON line:
  device   the card (exits non-zero when torch.cuda.is_available() is false)
  build    nvcc builds every kernel of src/repro_torch/kernels/csrc (build/)
  data     an Illumina set at full block width (120 kbp reference, depth 4,
           token_target 65536: 8 blocks of C = 65558) tiled x4096 to 32768
           blocks (~2 Gbases) in a codec v2 container, plus ONT and HiFi
           sets at the test fixtures' size in their own containers; each
           set is encoded by the sequential encoder and by the batched one
           on the card (banded-DP kernel, B2 verify), whose SageFile must
           equal the sequential one field for field
  kernels  each kernel against its plain torch version on the card at the
           main path's shapes, timed with CUDA events beside its bound
           (device time, and the call time that includes launch overhead)
           and the launch floor (a near-empty kernel timed the same way);
           B6 and its backward also at the hybrid phase's train shape
           (zamba2-2.7b: 8 x 512 tokens, 80 heads, N = 64), and B6's decode
           route at its decode step (8 prompts, Q = 1), timed;
           the launch plans of B1 and B3 (grid, threads, shared memory, and
           registers and spills from this run's build) and of B2 and B5
           (grid, shared memory, global scratch);
           the fused kernel B5 in each format on a 256-lane bucket of
           permuted, repeated and invalid lanes, also against B2 -> B3 / B4;
           the SSD intra-chunk kernel B6 at mamba2-370m's prefill (8 x 512
           tokens, Q = 128; tensor-core route) and decode (Q = 1; its own
           route) shapes in bf16 and f32, chunks of 2, 17 and 127 steps,
           zamba2-2.7b's N = 64, and large-decay cases in f32 and bf16 (TF32
           off for matmul and cuDNN); B6's rows carry the share of the bound
           reached; B6's backward kernel at the train shape (the prefill
           shape, bf16 x; timed, with its plan: CTAs, threads, shared
           memory, ptxas registers and spills) and in f32, at large decay,
           Q = 1, 17, 64 and 120 and
           N = 64, against ssd_intra_bwd_plain; the banded-alignment DP on one 1024-lane chunk of the
           batched mapper's Illumina lanes (L 150, band 24) and every card case of
           tests/dp_cases.py (widths up to 1023, both store routes), bit for
           bit, each case timed, with its plan (layout, route, grid, threads,
           shared memory, ptxas registers and spills); int32 bounds use the
           card's int32 rate (64 a clock an SM x SMs x clocks.max.sm)
  main     SageStore(device="cuda"): session.read of 256-block ranges in
           2bit / kmer / onehot, a 4096-block dispatch-mode kmer stream, and
           every ONT and HiFi block in all three formats; then a fused
           session: a 256-block read in each format (one B5 launch each, no
           B2 / B3 / B4), a 4096-block pipelined kmer stream, and 16
           SageTokenPipeline batches plus 8 restored from its cursor. Every
           decoded block is held read for read against
           repro_torch.core.refdec, every batch against refdec's k-mer
           stream, and the launch counts of the run show the path went
           through every kernel; the peak device memory of each step
  profile  5 warm 256-block reads (two-step and fused) and a cold
           1024-block stream (dispatch mode, and pipelined on a fused
           session), each timed on the host clock and then repeated under
           torch.profiler: device time by kernel, the device busy share, the
           host->device copy time that overlapped a kernel, and the
           pipelined stream's stage seconds and overlap_fraction
  encode   batched SAGe_Write on the card of ~33,300 Illumina reads over a
           1 Mbp reference (token_target 65536): bases/s, t_map / t_pack /
           t_verify, launch counts from 0 (DP kernel and B2, no plain
           call), the mapper's stats, every read back by refdec, peak
           device memory, profiles of the mapper's align_rows call and of
           one verify (the DP kernel's total device time)
  isp      filter_store_blocks (two-step session) and map_store_reads
           (fused session) on 8 blocks of the Illumina container on the
           card, each equal to the same call through a CPU store
  lm       mamba2-370m at full width (48 layers, d_model 1024, weights from
           a seeded generator on the card): 8 prompts from the Illumina
           container through a fused kmer session (k = 7; B1, B5), two
           greedy ServingEngine.generate calls (512-token slots, 64 new
           tokens; 48 x 64 B6 launches each, no plain call, the same tokens
           twice); prompts against the CPU; a 4-layer cut's f32 and bf16
           prefill logits against the CPU; chunked prefill against
           step-by-step decode on that cut; time to first token, decode
           ms per step, peak memory, profiles of a prefill and 4 decode steps
  serve    SageServer over a card store and the lm phase's engine: one burst
           of 64 overlapping 4-block reads (2bit / kmer / onehot), 4 kmer
           streams of 256 blocks, 2 consensus requests and 8 generates
           (512-token prompts, 64 new tokens), drained synchronously; every
           chunk against a direct two-step read and refdec, consensus
           against the store, generates against a direct engine.generate;
           launch counts from 0 (B1-B4, B6, no plain call); batcher stats;
           the 64 reads on warm groups one at a time through session.read
           against the same through the server (ms a request, launches a
           request); a profiled warm server round; a background-thread
           server whose every handle is waited on with a timeout
  heal     an xor parity container (groups of 4) of 1024 full-width blocks:
           damage in two parity groups read back through reconstruction
           (two-step and fused, against refdec, timed against a clean
           read); reads under an EIO-every-5 / one-flip plan through the
           server; a scrubber sweep that repairs the medium, an unlimited
           and a half-rate sweep, one timed group repair; then two damaged
           extents in one parity group fail only the requests touching
           them (repair attempted once, group quarantined)
  train    mamba2-370m at full width (weights from a seeded generator on
           the card) trained by the port's Trainer for 8 steps of 8 x 512
           k-mer tokens (k = 7) from a fused SageTokenPipeline over Illumina
           tiles no earlier phase touched, remat on, bf16 activations, a
           checkpoint at step 4: every batch against refdec's k-mer stream,
           losses finite and falling, launch counts from 0 (B6 forward
           96 and backward 48 a step, B1 and B5, no plain call); the step-4
           checkpoint restored into a fresh Trainer and pipeline gives the
           same batches and losses for steps 5-8 within 1e-3; a 2-layer
           full-width cut's step (f32 activations) against the CPU, every
           leaf within tests/train_cases.py's bounds; step ms, tokens/s,
           peak memory, checkpoint bytes, a profile of one step (with
           B6 backward's device ms and launches inside it)
  dense    qwen2-1.5b at full width (28 layers, d_model 1536, 12 / 2 heads
           of 128, vocab 151936, tied; weights from a seeded generator on
           the card): 8 prompts from an Illumina block through a fused kmer
           session (k = 8; B1, B5), two greedy generate calls (512-token
           slots, 64 new tokens) held against each other and the CPU's
           prompts; TTFT, decode ms a step, tokens/s, peak memory, profiles
           of a prefill and 4 decode steps with the device time inside the
           attention; a 4-layer cut's f32 and bf16 prefill (logits, K and
           V) against the CPU; chunked forward and prefill against
           step-by-step decode on the cut; 4 training steps of 8 x 512
           k-mer tokens through the Trainer (no checkpoint: ~18 GB) on
           tiles 3100-3101, remat, bf16, AdamW: every batch against refdec,
           the loss falls, launch counts, a profiled step; a 2-layer cut's
           train step against the CPU (tests/train_cases.py); the
           attention beside one scaled_dot_product_attention call at the
           train shape, forward and forward + backward
  hybrid   zamba2-2.7b at full width (54 Mamba2 layers in 9 groups of 6,
           d_model 2560, one shared attention block of 32 heads of 80):
           the same serving run (B6 once a Mamba2 layer a decode step), the
           same checks on a cut of one group and the shared block, 3
           training steps on tiles 3200-3201 (B6 forward twice and backward
           once a Mamba2 layer a step; B6 backward's device ms inside the
           profiled step), the cut's train step and the attention against
           the CPU and the library
  moe      deepseek-moe-16b at full width (d_model 2048, 16 / 16 heads of
           128, 64 routed experts of d_ff 1408, top-6, 2 shared, vocab
           102400, untied; weights from a seeded generator on the card),
           cut in depth to fit the card (16.9 B parameters, 67.5 GB in
           f32): 16 of 28 layers served, 4 trained; the dense phase's runs
           (block 26688, tiles 3300-3301) plus the device time inside
           moe_apply in each profile and the share of (token, choice) pairs
           the serving prefill dropped past capacity; its card-vs-CPU cut
           (2 layers; a 1-layer train step) routes the card as the CPU was
           routed, every difference a near tie (tests/moe_cases.py), and
           prints the share of decisions that agreed; its duality runs at
           capacity_factor = 64 / 6, which drops no pair; the aux loss of
           each training step
Then the kernel table as one JSON line (B1's, B2's, B3's, B5's and B6
backward's rows with their launch `plan`, B1's and B3's with the launch
floor), the card's name and power limit,
and the final {"ok": true, ...} line. Any failure raises (exit code != 0).
"""

from __future__ import annotations

import contextlib
import copy
import dataclasses
import functools
import io
import json
import re
import shutil
import subprocess
import sys
import time
from pathlib import Path

import numpy as np

ROOT = Path(__file__).resolve().parent
sys.path.insert(0, str(ROOT / "src"))

try:
    import torch

    from repro_torch.configs import get_arch
    from repro_torch.core import SageStore, Scrubber
    from repro_torch.core.api import kmer_vocab_size, pick_k
    from repro_torch.core.bitio import unpack_2bit
    from repro_torch.core.blocks import block_row_widths, localize_directory, pad_block_ids
    from repro_torch.core.decode_torch import (
        DeviceBlocks,
        _fill_counts,
        gather_block_arrays,
        host_to_tensor,
        prepare_device_blocks,
        reset_trace_counts,
        trace_counts,
    )
    from repro_torch.core.encoder import SageEncoder
    from repro_torch.core.errors import IntegrityError
    from repro_torch.core.format import D, STREAMS, SageFile
    from repro_torch.core import layout
    from repro_torch.core.layout import SageContainerV2, write_v2
    from repro_torch.core.refdec import decode_all, decode_block
    from repro_torch.data import SageTokenPipeline
    from repro_torch.genomics.batch_map import _batch_candidates, _traceback_batch
    from repro_torch.genomics.filter_torch import filter_store_blocks
    from repro_torch.genomics.mapper import ReadMapper, map_store_reads
    from repro_torch.genomics.synth import make_reference, revcomp, sample_read_set
    from repro_torch.kernels import cuda_lib, ops, ref
    from repro_torch.kernels.banded_align import align_plan, align_rows, dp_inputs
    from repro_torch.kernels.reformat import kmer_plan
    from repro_torch.kernels.sage_decode import launch_plan, unpack_plan
    from repro_torch.kernels.ssd_chunk import (bwd_plan, ssd_intra, ssd_intra_bwd, ssd_intra_bwd_plain,
                                               ssd_intra_plain)
    from repro_torch.models import layers as LAYERS
    from repro_torch.models import lm
    from repro_torch.models import moe as MOE
    from repro_torch.serving import SageServer, ServeConfig, ServingEngine, SessionPool, prompts_from_store
    from repro_torch.testing import FaultPlan, corrupt_extents, inject
    from repro_torch.training import Trainer, TrainerConfig, TrainOptions, init_train_state
    from repro_torch.training.optimizer import AdamWConfig

    sys.path.insert(0, str(ROOT / "tests"))
    from dp_cases import CARD_DP_CASES, scan_inputs  # the DP's card test cases (numpy + the port)
    from train_cases import compare_step, cut_batch, cut_models, one_step  # a train step, card vs CPU
    from moe_cases import dropped_share, recorded, replayed  # the MoE router's decisions, card vs CPU
except ImportError as e:  # run outside a checkout of the repository
    print(f"chip_smoke: cannot import the port ({e}); run from the repository root", file=sys.stderr)
    sys.exit(2)

HBM_BYTES_PER_S = 3.35e12  # H100 SXM HBM3
# 32-bit integer adds, compares, min/max or logic ops a clock an SM (CUDA C
# Programming Guide, arithmetic instruction throughput, compute capability
# 9.0); B1-B5 and the DP are bound by int32_ops_per_s()
INT_OPS_PER_CLOCK_PER_SM = 64
B6_OPS_PER_S = 495e12 / 3  # B6's f32-accurate route: 3 TF32 products (3xTF32) at the dense TF32 rate
SPIN_HZ = 2.0e9  # >= the H100's SM clock, so a spin of n cycles lasts at least n / SPIN_HZ s
# Illumina at full width: 8 source blocks of C = 65558 tokens
ILLUMINA = dict(ref_len=120_000, ref_seed=7, depth=4, seed=8, token_target=65536,
                blocks=8, tokens=65558)
TILES = 4096  # 8 x 4096 = 32768 blocks, ~2 Gbases
GROUP = 32  # store group_blocks: one codec upload + unpack launch per group
BUCKET = 256  # blocks per session.read (one decode bucket)
N_STREAM, PER_FETCH = 4096, 64  # SAGe_ISP stream length and fetch size
N_PROFILE = 1024  # blocks of each profiled cold stream; they start at 1x and 2x this
PIPE_START = 8192  # the fused session's 4096-block pipelined stream starts here
PIPE_PROFILE = 16384  # the profiled pipelined streams start at this + 0x / 1x N_PROFILE
FUSED_READ = 16 * GROUP  # the fused session's 256-block reads start here
TOKENS = dict(batch=8, seq_len=2048, n_batches=16, restore_after=8)
WARM_READS = 5  # reads in each profiled warm-read window
KMER_K = 4
FMTS = ("2bit", "kmer", "onehot")
LM_ARCH = "mamba2-370m"  # full width; the card-vs-CPU and duality checks cut its depth
LM = dict(seed=0, prompts=8, cut_layers=4, duality_tokens=160, prefill_runs=2, decode_steps=16, profile_steps=4)
LM_BLOCK = 3 * GROUP  # the lm phase's prompts come from this block, through a store of its own
# B6 against its plain version, (rtol, atol). bf16 y: both sides round an f32
# sum once, so they differ by at most one bf16 ulp (2^-7 of the value) past
# the f32 rows' 1e-5 for the order of the sum
B6_TOL = {"y_f32": (1e-5, 1e-5), "y_bf16": (8e-3, 1e-5), "state": (1e-4, 1e-4), "total": (1e-5, 1e-5)}
# the encode phase: batched SAGe_Write of Illumina reads over a 1 Mbp
# reference (~33,300 reads of 150 bases); cut: scale only (an isolate at
# 30x would be 4.6 Mbp), read length, band and width are not cut
ENCODE = dict(ref_len=1_000_000, ref_seed=31, depth=5, seed=32, token_target=65536)
DP_LANES = 1024  # the kernels phase's DP chunk: one full lane bucket (MAX_CHUNK_LANES)
# int32 operations of one DP cell in its per-cell form (csrc/banded_align.cu):
# the window column's valid test (1), the match compare (1), the mismatch and
# off-window penalties into diag (2), up + 1 (1), min(diag, up) and its move
# bit (2), left + 1 and the off-window gate (2), the min with left and its
# move bit (2), the move's three-way select (2)
DP_OPS_PER_CELL = 13
ISP_BLOCKS = (0, 8)  # the isp phase's block range of the Illumina container
# the serve phase: one burst through SageServer on blocks no earlier phase
# touched: 64 reads of 4 blocks (request i covers [start + 2i, start + 2i + 4)),
# 4 kmer streams of 256 blocks, 2 consensus requests, 8 generates
SERVE = dict(start=20480, reads=64, read_blocks=4, streams=4, stream_blocks=256, per_fetch=32,
             consensus=((0, 8), (64, 72)), generates=8, gen_start=22016,
             bg_reads=16, profile_reads=16)
# the heal phase: an xor parity container (parity groups of 4) of the first
# 128 tiles (1024 blocks); damage within the budget in two parity groups,
# an in-flight EIO / flip plan, then two damaged extents in one parity group
HEAL = dict(tiles=128, parity_group=4, damaged=(5, 100), flip_block=300, repair_block=700,
            beyond=(200, 201))
# the train phase: mamba2-370m at full width, 8 steps of 8 x 512 k-mer tokens
# (k = 7) from tiles 3072-3073 of the Illumina layout (blocks 24576-24591, which
# no earlier phase touched) in a container of their own (a pipeline's cursor
# counts from its dataset's first block); a checkpoint at step 4 resumed by a
# fresh trainer and pipeline; a 2-layer full-width cut's step against the CPU
TRAIN = dict(first_tile=3072, tiles=2, batch=8, seq=512, steps=8, ckpt_at=4, seed=5, lr=2e-3, warmup=2,
             cut_layers=2, cut_batch=2, resume_rtol=1e-3)
# the dense, hybrid and moe phases: qwen2-1.5b, zamba2-2.7b and
# deepseek-moe-16b at full width, weights from a seeded generator on the
# card. Each serves 8 prompts from an Illumina block of a store of its own
# (512-token slots, 64 new tokens) and trains on 8 x 512 k-mer tokens a step
# from two tiles of the Illumina layout no earlier phase touched (qwen2 tiles
# 3100-3101, blocks 24800-24815; zamba2 tiles 3200-3201, blocks 25600-25615;
# deepseek tiles 3300-3301, blocks 26400-26415), with no checkpoint (a save
# would be ~18 GB); the CPU checks run on a depth cut (zamba2's: one group
# of 6 Mamba2 layers and the shared block). deepseek-moe-16b (16.9 B
# parameters, 67.5 GB in f32) does not fit the card whole: it serves 16 of
# its 28 layers (f32 weights and their bf16 copies, ~58 GB) and trains 4
# (2.77 B parameters at 16 bytes each for parameters, gradients, m and v)
FAMILY = {
    "dense": dict(arch="qwen2-1.5b", seed=11, prompt_block=26624, first_tile=3100, steps=4, cut_layers=4,
                  train_cut_layers=2),
    "hybrid": dict(arch="zamba2-2.7b", seed=12, prompt_block=26656, first_tile=3200, steps=3, cut_layers=6,
                   train_cut_layers=6),
    "moe": dict(arch="deepseek-moe-16b", seed=13, prompt_block=26688, first_tile=3300, steps=3, cut_layers=2,
                train_cut_layers=1, serve_layers=16, train_layers=4),
}
FAMILY_RUN = dict(prompts=8, tiles=2, batch=8, seq=512, lr=2e-3, warmup=2, cpu_prompts=2, duality_tokens=160,
                  duality_chunk=64, prefill_runs=2, decode_steps=8, profile_steps=4, cut_batch=2, cut_seq=128,
                  attn_iters=20)
BF16_OPS_PER_S = 989e12  # H100 SXM dense bf16 tensor-core rate (bf16 products, f32 sums)
# B6's backward against its plain version, (rtol, atol as a share of the
# plain gradient's largest value): f32 sums of up to Q·N products in
# another order; dx in bf16 within one bf16 ulp
B6_BWD_TOL = {"f32": (1e-5, 1e-5), "dx_bf16": (8e-3, 1e-5)}
WORK = ROOT / "build" / "smoke_data"


def emit(phase: str, **kw) -> None:
    print(json.dumps({"phase": phase, **kw}), flush=True)


def smi() -> str:
    return subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
        capture_output=True, text=True, check=True,
    ).stdout.strip()


def _events_ms(fn, iters: int, hold_s: float = 0.0) -> float:
    start, end = torch.cuda.Event(enable_timing=True), torch.cuda.Event(enable_timing=True)
    if hold_s:
        torch.cuda._sleep(int(hold_s * SPIN_HZ))
    start.record()
    for _ in range(iters):
        fn()
    end.record()
    torch.cuda.synchronize()
    return start.elapsed_time(end) / iters


def cuda_ms(fn, iters: int, warmup: int = 2) -> tuple[float, float]:
    """(device ms, call ms) per call of ``fn``, each from CUDA events over
    ``iters`` warm calls. Call: the calls run as fast as the host issues
    them, so launch overhead counts. Device: a spin kernel holds the stream
    while every call is enqueued, so the events see only device work."""
    for _ in range(warmup):
        fn()
    torch.cuda.synchronize()
    call = _events_ms(fn, iters)
    return _events_ms(fn, iters, hold_s=2e-3 * iters * call), call


def timings(kernel, iters: int, plain, plain_iters: int) -> dict:
    """Device and host-paced call times of a kernel wrapper, and the device
    time of its plain version."""
    ms, call_ms = cuda_ms(kernel, iters)
    return dict(ms=ms, call_ms=call_ms, plain_ms=cuda_ms(plain, plain_iters, warmup=1)[0])


def copy_overlap_us(events) -> tuple[float, float]:
    """(host->device copy time, the part of it that ran while a kernel ran)
    over the device events of a profile, in microseconds."""
    from torch.autograd import DeviceType

    dev = [e for e in events if e.device_type == DeviceType.CUDA]
    copies = [(e.time_range.start, e.time_range.end) for e in dev if e.name.startswith("Memcpy HtoD")]
    kernels = sorted((e.time_range.start, e.time_range.end) for e in dev
                     if not e.name.startswith(("Memcpy", "Memset")))
    merged: list[list[float]] = []  # union of kernel intervals
    for a, b in kernels:
        if merged and a <= merged[-1][1]:
            merged[-1][1] = max(merged[-1][1], b)
        else:
            merged.append([a, b])
    both = sum(max(0.0, min(b, kb) - max(a, ka)) for a, b in copies for ka, kb in merged)
    return sum(b - a for a, b in copies), both


@contextlib.contextmanager
def annotated(ranges):
    """Wrap each ``(module, name)`` function in ``torch.profiler.record_function(name)``
    for the duration, so a profile can attribute device time to it."""
    from torch.profiler import record_function

    saved = [(mod, name, getattr(mod, name)) for mod, name in ranges]

    def wrap(fn, name):
        def run(*a, **kw):
            with record_function(name):
                return fn(*a, **kw)
        return run

    for mod, name, fn in saved:
        setattr(mod, name, wrap(fn, name))
    try:
        yield
    finally:
        for mod, name, fn in saved:
            setattr(mod, name, fn)


def profile_window(fn, focus: str = "", ranges=(), kernels=()) -> dict:
    """Run ``fn(0)`` on the host clock and ``fn(1)``, the same work, under
    torch.profiler: the wall time of the first, the device time of every
    kernel and copy by name in the second, the device busy share (device
    time over the unprofiled wall time; null when the profiler saw no device
    activity), how much of the host->device copy time overlapped a kernel,
    with ``focus`` the device time and share of the kernels whose name
    holds it, and with ``ranges`` ((module, function name) pairs, wrapped
    in ``record_function`` for the profiled run only) the device time of
    the kernels launched inside each function and its share, and for each
    name in ``kernels`` the device time and launches of the kernels whose
    name holds it."""
    from torch.autograd import DeviceType
    from torch.profiler import ProfilerActivity, profile

    torch.cuda.synchronize()
    t0 = time.perf_counter()
    fn(0)
    torch.cuda.synchronize()
    wall_us = (time.perf_counter() - t0) * 1e6
    with annotated(ranges), profile(activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA]) as prof:
        fn(1)
        torch.cuda.synchronize()
    names = {name for _mod, name in ranges}  # their ranges also show on the device's timeline: not kernels
    rows = sorted(((e.key, e.self_device_time_total, e.count) for e in prof.key_averages()
                   if e.device_type == DeviceType.CUDA and e.key not in names), key=lambda r: -r[1])
    busy_us = sum(r[1] for r in rows)
    htod_us, htod_under_kernel_us = copy_overlap_us(prof.events())
    out = {"wall_ms": wall_us / 1e3, "device_ms": busy_us / 1e3,
           "device_busy_share": busy_us / wall_us if rows else None,
           "htod_ms": htod_us / 1e3, "htod_overlapping_kernels_ms": htod_under_kernel_us / 1e3,
           "device_ms_by_name": [{"name": n[:60], "ms": t / 1e3, "count": c} for n, t, c in rows[:8]]}
    if focus:
        f_us = sum(t for n, t, _c in rows if focus in n)
        out.update({f"{focus}_ms": f_us / 1e3, f"{focus}_share": f_us / busy_us if busy_us else None,
                    "device_kernels": sum(c for _n, _t, c in rows)})
    for sub in kernels:
        out[f"{sub}_ms"] = sum(t for n, t, _c in rows if sub in n) / 1e3
        out[f"{sub}_launches"] = sum(c for n, _t, c in rows if sub in n)
    for name in names:  # the kernels launched inside each call of the function, from the host's events
        r_us = sum(e.device_time_total for e in prof.events()
                   if e.name == name and e.device_type == DeviceType.CPU)
        out[f"{name}_ms"] = r_us / 1e3
        out[f"{name}_share"] = r_us / busy_us if busy_us else None
    return out


def launch_floor_ms(iters: int = 200) -> float:
    """Device time of a near-empty launch (``torch.cuda._sleep(1)``), timed
    as ``cuda_ms`` times a kernel: the least a launch costs in a run of
    launches on one stream."""
    return cuda_ms(lambda: torch.cuda._sleep(1), iters)[0]


def ptxas_usage(lib: str, kernel: str) -> dict:
    """Registers and spill bytes ptxas reported when this run built ``lib``,
    for the first kernel whose mangled name holds ``kernel`` (None when the
    library was loaded from an earlier build, whose log this run lacks)."""
    out = {"registers": None, "spill_store_bytes": None, "spill_load_bytes": None}
    cur = ""
    for ln in cuda_lib.BUILD_INFO.get(lib, {}).get("log", "").splitlines():
        m = re.search(r"(?:Compiling entry function|Function properties for) '?(\w+)", ln)
        if m:
            cur = m.group(1)
        elif kernel in cur:
            m = re.search(r"(\d+) bytes spill stores, (\d+) bytes spill loads", ln)
            if m:
                out["spill_store_bytes"], out["spill_load_bytes"] = int(m.group(1)), int(m.group(2))
            m = re.search(r"Used (\d+) registers", ln)
            if m:
                out["registers"] = int(m.group(1))
                return out
    return out


@functools.cache
def int32_ops_per_s() -> float:
    """The card's int32 rate: INT_OPS_PER_CLOCK_PER_SM x its SMs x the max SM
    clock nvidia-smi reports (clocks.max.sm)."""
    mhz = subprocess.run(["nvidia-smi", "--query-gpu=clocks.max.sm", "--format=csv,noheader,nounits"],
                         capture_output=True, text=True, check=True).stdout.split()[0]
    sms = torch.cuda.get_device_properties(0).multi_processor_count
    return INT_OPS_PER_CLOCK_PER_SM * sms * float(mhz) * 1e6


def bound(nbytes: int, ops_: int, ops_per_s: float | None = None) -> tuple[float, str]:
    t_b, t_o = nbytes / HBM_BYTES_PER_S * 1e3, ops_ / (ops_per_s or int32_ops_per_s()) * 1e3
    return (t_b, "bytes") if t_b >= t_o else (t_o, "operations")


def source_block(b: int, n_src: int) -> int:
    """Source block at position ``b`` of a tiled container. Tile ``t`` holds
    the source blocks rotated by a hash of ``t``, so a gather that serves the
    blocks of another tile in place of a range's own disagrees with refdec."""
    t, j = divmod(int(b), n_src)
    h = (t * 0x9E3779B97F4A7C15) & (2**64 - 1)
    h ^= h >> 31
    h = (h * 0xBF58476D1CE4E5B9) & (2**64 - 1)
    return (j + (h >> 33)) % n_src


def tile_sage_file(sf: SageFile, times: int, first: int = 0) -> SageFile:
    """Replicate a container block-wise ``times`` x: tiles ``first`` to
    ``first + times - 1`` of the tiled layout. Tile ``t`` lays out the
    words of its source blocks in ``source_block`` order (blocks start on
    word boundaries), so directory offsets stay monotonic, as the encoder
    writes them, and every tiled block decodes exactly like its source
    block. Consensus is shared across tiles (reads re-map the same
    reference), matching how depth scales in a real dataset."""
    if times <= 1 and first == 0:
        return sf
    n = sf.meta.n_blocks
    sizes = {s: int(sf.streams[s].size) for s in STREAMS}
    layouts: dict[tuple, tuple] = {}  # source order -> (streams, offsets in words)
    tile_streams: dict[str, list] = {s: [] for s in STREAMS}
    tiles = []
    for i, t in enumerate(range(first, first + times)):
        order = tuple(source_block(t * n + j, n) for j in range(n))
        if order not in layouts:
            words, offs = {}, {}
            for s in STREAMS:
                off = sf.directory[:, D[f"off_{s}"]].astype(np.int64)
                assert (off % 32 == 0).all() and off[0] == 0 and (np.diff(off) >= 0).all(), s
                w0 = off // 32
                w1 = np.append(w0[1:], sizes[s])
                parts = [sf.streams[s][w0[j]:w1[j]] for j in order]
                words[s] = np.concatenate(parts) if parts else sf.streams[s][:0]
                offs[s] = np.cumsum([0] + [p.size for p in parts[:-1]])
            layouts[order] = (words, offs)
        words, offs = layouts[order]
        d = sf.directory[list(order)].copy()
        for s in STREAMS:
            tile_streams[s].append(words[s])
            d[:, D[f"off_{s}"]] = (i * sizes[s] + offs[s]) * 32
        tiles.append(d)
    streams = {s: np.concatenate(tile_streams[s]) for s in STREAMS}
    bits = dict(sf.meta.stream_bits)
    bits.update({s: sizes[s] * 32 * times for s in STREAMS})
    meta = dataclasses.replace(
        sf.meta,
        n_blocks=n * times,
        n_reads=sf.meta.n_reads * times,
        n_segments=sf.meta.n_segments * times,
        stream_bits=bits,
    )
    return SageFile(meta=meta, consensus2b=sf.consensus2b,
                    directory=np.concatenate(tiles), streams=streams)


def read_multiset(tokens: np.ndarray, starts: np.ndarray, lens: np.ndarray, n: int) -> list[bytes]:
    return sorted(bytes(tokens[s : s + ln].astype(np.uint8)) for s, ln in zip(starts[:n], lens[:n]))


class Oracle:
    """refdec read multisets of a container's source blocks; block b of a
    tiled container is source block ``source_block(b, n_src)``."""

    def __init__(self, sf: SageFile) -> None:
        cons = unpack_2bit(sf.consensus2b, sf.meta.cons_len)
        self.n_src = sf.meta.n_blocks
        self.C = sf.meta.caps.tokens
        reads = [decode_block(sf, b, cons) for b in range(self.n_src)]
        self.want = [sorted(bytes(np.asarray(r.seq, np.uint8)) for r in rs) for rs in reads]
        # each block's token row: its reads back to back, in block order
        self.rows = [np.concatenate([np.asarray(r.seq, np.int8) for r in rs]) for rs in reads]

    def kmer_stream(self, block_ids, k: int) -> np.ndarray:
        """refdec's k-mer stream of ``block_ids`` in order, PAD groups
        dropped (the token pipeline's contract)."""
        parts = []
        for b in np.asarray(block_ids):
            row = self.rows[source_block(b, self.n_src)]
            toks = np.full(self.C, 4, np.int8)
            toks[: row.size] = row
            km = ref.kmer_pack_ref(torch.from_numpy(toks)[None], k, torch.tensor([row.size]))
            parts.append(km[0, : row.size // k].numpy())
        return np.concatenate(parts)

    def check(self, out: dict, block_ids: np.ndarray, what: str) -> int:
        """``out``: a session read (tensors) or a served chunk (host arrays)."""
        toks = host(out["tokens"])
        st, ln = host(out["read_start"]), host(out["read_len"])
        nr = host(out["n_reads"])
        for i, b in enumerate(np.asarray(block_ids)):
            got = read_multiset(toks[i], st[i], ln[i], int(nr[i]))
            if got != self.want[source_block(b, self.n_src)]:
                raise AssertionError(f"{what}: block {int(b)} disagrees with refdec")
        return int(len(block_ids))


def host(v) -> np.ndarray:
    return v.cpu().numpy() if isinstance(v, torch.Tensor) else np.asarray(v)


def max_abs_err(a: torch.Tensor, b: torch.Tensor) -> float:
    if a.is_floating_point():
        return float((a.float() - b.float()).abs().max())
    return float((a.long() - b.long()).abs().max())


def check_format(out: dict, fmt: str) -> None:
    toks = out["tokens"]
    if fmt == "kmer":
        want = ref.kmer_pack_ref(toks, KMER_K, out["n_tokens"])
        assert out["kmer"].shape == want.shape and torch.equal(out["kmer"], want), "kmer plane"
    elif fmt == "onehot":
        oh = out["onehot"]
        assert oh.shape == toks.shape + (4,) and bool(torch.isfinite(oh.float()).all())
        assert torch.equal(oh, ref.one_hot_ref(toks)), "onehot plane"


def ssd_inputs(shape, x_dtype, decay: str, seed: int, dev):
    """Inputs of B6 on the card, made from a seed. ``serve``: mamba2-370m's
    init (A = -1..-16 over the heads, dt = softplus(z + dt_bias) with
    dt_bias = log(expm1(0.01))); ``unit``: tests/test_kernels.py's draw;
    ``large``: A = -1..-16 and dt near 2, so exp of the upper triangle of a
    chunk overflows to +inf and a mask applied as a product would give NaN."""
    Bb, nc, Q, H, P, N = shape
    g = torch.Generator(device=dev).manual_seed(seed)
    x = torch.randn((Bb, nc, Q, H, P), generator=g, device=dev).to(x_dtype)
    z = torch.randn((Bb, nc, Q, H), generator=g, device=dev)
    if decay == "unit":
        dt, A = torch.nn.functional.softplus(z), -torch.exp(torch.randn((H,), generator=g, device=dev) * 0.3)
    else:
        shift = 2.0 if decay == "large" else float(np.log(np.expm1(0.01)))
        dt, A = torch.nn.functional.softplus(z + shift), -torch.linspace(1.0, 16.0, H, device=dev)
    B = torch.randn((Bb, nc, Q, H, N), generator=g, device=dev) * 0.3
    C = torch.randn((Bb, nc, Q, H, N), generator=g, device=dev) * 0.3
    return x, dt, (dt * A).contiguous(), B, C


def ssd_bound(shape, x_bytes: int) -> tuple[float, str]:
    """B6's least time: x, dt, a, B, C read once, y, the chunk state and the
    total written once, over HBM_BYTES_PER_S; Q(Q+1)N + Q(Q+1)P + 2QNP f32
    operations a (b, chunk, head) over B6_OPS_PER_S (the function is causal,
    so C·Bᵀ and M·(x·dt) need only their Q(Q+1)/2 entries on and below the
    diagonal, and the state 2QNP); the larger of the two."""
    Bb, nc, Q, H, P, N = shape
    rows = Bb * nc * Q * H
    nbytes = 2 * rows * P * x_bytes + 2 * rows * 4 + 2 * rows * N * 4 + Bb * nc * H * (P * N + 1) * 4
    ops = Bb * nc * H * (Q * (Q + 1) * N + Q * (Q + 1) * P + 2 * Q * N * P)
    return bound(nbytes, ops, B6_OPS_PER_S)


def ssd_check(args, x_dtype) -> dict:
    """B6 against its plain version on the same inputs: max abs errors and
    whether each output lies within B6_TOL."""
    y, st, tot = ssd_intra(*args)
    yp, sp, tp = ssd_intra_plain(*args)
    torch.cuda.synchronize()
    ytol = B6_TOL["y_f32"] if x_dtype == torch.float32 else B6_TOL["y_bf16"]
    out = {"finite": all(bool(torch.isfinite(t.float()).all()) for t in (y, st, tot))}
    for key, a, b, tol in (("y", y, yp, ytol), ("state", st, sp, B6_TOL["state"]),
                           ("total", tot, tp, B6_TOL["total"])):
        out[f"{key}_err"] = max_abs_err(a, b)
        out[f"{key}_ok"] = bool(torch.allclose(a.float(), b.float(), rtol=tol[0], atol=tol[1]))
    out["match"] = out["finite"] and out["y_ok"] and out["state_ok"] and out["total_ok"]
    return out


def ssd_grads(shape, x_dtype, seed: int, dev):
    """dy (x's dtype), dst and dtotal of B6's backward, made from a seed."""
    Bb, nc, Q, H, P, N = shape
    g = torch.Generator(device=dev).manual_seed(seed)
    return (torch.randn((Bb, nc, Q, H, P), generator=g, device=dev).to(x_dtype),
            torch.randn((Bb, nc, H, P, N), generator=g, device=dev),
            torch.randn((Bb, nc, H), generator=g, device=dev))


def ssd_bwd_bound(shape, x_bytes: int) -> tuple[float, str]:
    """B6 backward's least time: x, dy, dt, a, B, C, dst and dtotal read once,
    dx, ddt, da, dB and dC written once, over HBM_BYTES_PER_S;
    3Q(Q+1)N + 2Q(Q+1)P + 4QNP f32 operations a (b, chunk, head) over
    B6_OPS_PER_S, the card's rate for f32-accurate products, as ssd_bound
    (the rate of the card, not of this kernel's SIMT route). The causal
    products C·Bᵀ, dy·uᵀ, Mᵀ·dy, dS·B and dSᵀ·C need Q(Q+1)/2 entries each;
    dst·B and dstᵀ·x 2QNP each. The larger of the two."""
    Bb, nc, Q, H, P, N = shape
    rows = Bb * nc * Q * H
    nbytes = 3 * rows * P * x_bytes + 4 * rows * 4 + 4 * rows * N * 4 + Bb * nc * H * (P * N + 1) * 4
    ops = Bb * nc * H * (3 * Q * (Q + 1) * N + 2 * Q * (Q + 1) * P + 4 * Q * N * P)
    return bound(nbytes, ops, B6_OPS_PER_S)


def ssd_bwd_check(args) -> dict:
    """B6's backward against its plain version on the same inputs: max abs
    errors, the plain gradients' largest values, and whether each lies
    within B6_BWD_TOL."""
    got, want = ssd_intra_bwd(*args), ssd_intra_bwd_plain(*args)
    torch.cuda.synchronize()
    out = {"finite": all(bool(torch.isfinite(t.float()).all()) for t in got)}
    for key, a, b in zip(("dx", "ddt", "da", "dB", "dC"), got, want):
        rtol, atol = B6_BWD_TOL["dx_bf16" if a.dtype == torch.bfloat16 else "f32"]
        top = float(b.float().abs().max())
        out[f"{key}_err"], out[f"{key}_max"] = max_abs_err(a, b), top
        out[f"{key}_ok"] = bool(torch.allclose(a.float(), b.float(), rtol=rtol, atol=atol * top))
    out["match"] = out["finite"] and all(out[f"{k}_ok"] for k in ("dx", "ddt", "da", "dB", "dC"))
    return out


def dp_lanes(reads, cons: np.ndarray, mapper, L: int = 150):
    """The batched mapper's DP lanes of the N-free reads of length ``L``:
    both strands stacked, each lane's top seed cluster as its candidate,
    lanes without one or with an empty window dropped, exactly as
    ``batch_map_reads`` hands them to ``align_rows``. Returns (rows,
    cand, band)."""
    fwd = np.stack([r for r in reads if r.size == L and not (r == 4).any()])
    both = np.concatenate([fwd, np.stack([revcomp(r) for r in fwd])])
    has, cand, _ = _batch_candidates(mapper.index, both)
    band = mapper._band(L)
    ws, we = np.maximum(cand - band, 0), np.minimum(cons.size, cand + L + band)
    lanes = np.nonzero(has & (we - ws > 0))[0]
    return both[lanes], cand[lanes], band


def dp_check(args, band: int) -> dict:
    """The DP kernel against its plain version on the same card tensors."""
    mv, last = ops.banded_align(*args, band=band)
    p_mv, p_last = ref.banded_align_ref(*args, band=band)
    torch.cuda.synchronize()
    return {"shape": list(mv.shape), "max_abs_err": max(max_abs_err(mv, p_mv), max_abs_err(last, p_last))}


def encode_phase(dev) -> int:
    """Batched SAGe_Write on the card (banded-DP kernel, B2 verify) of the
    ENCODE read set: bases/s and the encoder's phase seconds, the path's
    launch counts from 0 (no plain call), every read back by refdec, peak
    device memory, and torch.profiler windows over the mapper's own
    ``align_rows`` call (every lane of the set) and one verify. Returns the
    DP kernel's launches on the path."""
    e = ENCODE
    t_phase = time.perf_counter()
    ref_seq = make_reference(e["ref_len"], seed=e["ref_seed"])
    rs = sample_read_set(ref_seq, "illumina", depth=e["depth"], seed=e["seed"])
    bases = int(sum(r.size for r in rs.reads))
    enc = SageEncoder(ref_seq, token_target=e["token_target"], device=dev)
    torch.cuda.synchronize()
    torch.cuda.reset_peak_memory_stats()
    held = torch.cuda.memory_allocated()  # earlier phases' live tensors (the main store's residency)
    reset_trace_counts()
    t0 = time.perf_counter()
    sf = enc.encode(rs)
    torch.cuda.synchronize()
    secs = time.perf_counter() - t0
    counts = trace_counts()
    peak = torch.cuda.max_memory_allocated()
    launches = {k: counts.get(f"launch:{k}", 0) for k in ("align_scan", "sage_decode")}
    plain = {k: v for k, v in counts.items() if k.startswith("plain:")}
    assert not plain, f"the encode path ran plain versions on the card: {plain}"
    assert all(launches.values()), f"the encode path never launched: {launches}"
    c0 = time.perf_counter()
    decoded = [np.asarray(d.seq, np.uint8) for d in decode_all(sf)]
    assert sorted(bytes(d) for d in decoded) == sorted(bytes(np.asarray(r, np.uint8)) for r in rs.reads), \
        "the batched encode is not lossless by refdec"
    check_s = time.perf_counter() - c0
    # where t_map goes, on the host clock: seeding and the DP call of the
    # 150-base lanes as the mapper makes them, the all-lanes traceback, and
    # the per-read mapper's seconds a read (times n_fallback: an estimate)
    s0 = time.perf_counter()
    rows, cand, band = dp_lanes(rs.reads, ref_seq, enc.mapper)
    seed_s = time.perf_counter() - s0
    dp_out = {}

    def dp_call(i):
        dp_out[i] = align_rows(rows, ref_seq, cand, band, device=dev)

    prof = {"align_rows_all_lanes": profile_window(dp_call, focus="align_scan"),
            "verify": profile_window(
                lambda _i: enc._decode_verify_failures(sf, decoded, dev), focus="decode_kernel")}
    s0 = time.perf_counter()
    _traceback_batch(*dp_out[0][:2], rows, ref_seq, *dp_out[0][2:])
    traceback_s = time.perf_counter() - s0
    del dp_out
    sample = np.random.default_rng(e["seed"]).choice(len(rs.reads), 200, replace=False)
    s0 = time.perf_counter()
    for i in sample:
        enc.mapper.map_read(rs.reads[i])
    map_read_s = (time.perf_counter() - s0) / sample.size
    st = enc.stats
    db = prepare_device_blocks(sf)
    split = {"seeding_s": seed_s, "align_rows_wall_s": prof["align_rows_all_lanes"]["wall_ms"] / 1e3,
             "traceback_s": traceback_s, "map_read_s_per_read": map_read_s,
             "fallback_s_estimate": map_read_s * st["n_fallback"]}
    emit("encode", ref_len=e["ref_len"], reads=len(rs.reads), bases=bases, blocks=sf.meta.n_blocks,
         token_target=e["token_target"], seconds=secs, bases_per_s=bases / secs,
         t_map=st["t_map"], t_pack=st["t_pack"], t_verify=st["t_verify"],
         stats={k: st[k] for k in ("n_batch_mapped", "n_fallback", "n_escaped", "verify_rounds")},
         launches=launches, plain_align_scan=counts.get("plain:align_scan", 0),
         dp_lanes=int(rows.shape[0]), band=band, peak_device_bytes=peak, held_before_bytes=held,
         encode_peak_device_bytes=peak - held, refdec_seconds=check_s,
         t_map_split=split, caps=dataclasses.asdict(sf.meta.caps),
         verify_plan=launch_plan(sf.meta.caps, db.arrays["cons"].shape[1], 1 << (sf.meta.n_blocks - 1).bit_length(),
                                 "decode", dev),
         align_scan_device_ms=prof["align_rows_all_lanes"]["align_scan_ms"],
         align_scan_share_of_t_map=prof["align_rows_all_lanes"]["align_scan_ms"] / 1e3 / st["t_map"],
         profile=prof, phase_seconds=time.perf_counter() - t_phase)
    return launches["align_scan"]


def isp_phase(ref_seq: np.ndarray) -> None:
    """SAGe_ISP consumers on ISP_BLOCKS of the Illumina container through
    card sessions: the exact-match filter (two-step session: B1, B2) and
    the store-backed mapper (fused session: B1, B5), each against the same
    call through a CPU store (plain versions); launch counts from 0."""
    t_phase = time.perf_counter()
    card = SageStore(group_blocks=GROUP)
    cpu = SageStore(device="cpu", group_blocks=GROUP)
    for s in (card, cpu):
        s.register("illumina", str(WORK / "illumina.sage2"))
    reset_trace_counts()
    t0 = time.perf_counter()
    masks, pruned, total = filter_store_blocks(card.session(), "illumina", ISP_BLOCKS)
    t_filter = time.perf_counter() - t0
    t0 = time.perf_counter()
    rep = map_store_reads(card.session(fused=True), "illumina", ref_seq, block_range=ISP_BLOCKS)
    t_mapped = time.perf_counter() - t0
    counts = trace_counts()
    plain = {k: v for k, v in counts.items() if k.startswith("plain:")}
    assert not plain, f"the isp path ran plain versions on the card: {plain}"
    launches = {k: counts.get(f"launch:{k}", 0) for k in ("sage_unpack", "sage_decode", "sage_fused")}
    assert all(launches.values()), f"the isp path never launched: {launches}"
    c_masks, c_pruned, c_total = filter_store_blocks(cpu.session(), "illumina", ISP_BLOCKS)
    assert masks.shape == c_masks.shape and np.array_equal(masks, c_masks), "filter masks: card != CPU"
    assert (pruned, total) == (c_pruned, c_total) and 0 < pruned < total, (pruned, total, c_pruned, c_total)
    c_rep = map_store_reads(cpu.session(fused=True), "illumina", ref_seq, block_range=ISP_BLOCKS)
    assert dataclasses.asdict(rep) == dataclasses.asdict(c_rep), (rep, c_rep)
    emit("isp", blocks=list(ISP_BLOCKS), filter={"pruned": pruned, "total": total, "seconds": t_filter},
         mapping={**dataclasses.asdict(rep), "seconds": t_mapped}, launches=launches,
         equal_to_cpu=True, seconds=time.perf_counter() - t_phase)


def slot_tokens(prompts, P: int) -> np.ndarray:
    """ServingEngine's slot layout: each prompt's first P tokens, left-padded."""
    toks = np.zeros((len(prompts), P), np.int64)
    for i, p in enumerate(prompts):
        p = p[:P]
        toks[i, P - len(p):] = p
    return toks


def state_err(a: dict, b: dict) -> float:
    return max(max_abs_err(a[k].cpu(), b[k].cpu()) for k in a)


def lm_phase(dev, cfg) -> tuple[int, ServingEngine]:
    """The LM serving path on the card: 8 prompts from the Illumina container
    through a fused kmer session of a store of its own, then two greedy
    ``ServingEngine.generate`` calls over mamba2-370m at full width with
    weights drawn from a seeded generator on the card. Checks the prompts
    against the same call on the CPU (plain versions), the tokens, the
    launch counts of the path, the card against the CPU on a 4-layer cut
    (f32 and bf16 prefill logits of 8 x 512 tokens) and the duality of
    chunked prefill and step-by-step decode on that cut; times prefill and
    decode and profiles one prefill and a few decode steps. Returns B6's
    launches on the path, and the engine over the full-width model (the
    serve phase serves it)."""
    t_phase = time.perf_counter()
    t0 = time.perf_counter()
    model = lm.init_params(torch.Generator(device=dev).manual_seed(LM["seed"]), cfg, device=dev)
    torch.cuda.synchronize()
    init_s = time.perf_counter() - t0
    n_params = sum(p.numel() for p in model.parameters())
    k = pick_k(cfg.vocab)
    sc = ServeConfig()
    engine = ServingEngine(cfg, model, sc)
    store = SageStore(max_prepared=4, group_blocks=GROUP)
    store.register("illumina", str(WORK / "illumina.sage2"))
    feed = dict(vocab=cfg.vocab, n_prompts=LM["prompts"], max_prompt=sc.max_prompt, kmer_k=k,
                block_range=(LM_BLOCK, LM_BLOCK + 1))

    # (a) the path: counts from 0, prompts through B1 + B5, two generate calls
    torch.cuda.synchronize()
    torch.cuda.reset_peak_memory_stats()
    reset_trace_counts()
    t0 = time.perf_counter()
    prompts = prompts_from_store(store.session(fused=True), "illumina", **feed)
    prompt_s = time.perf_counter() - t0
    gens, gen_s, per_gen = [], [], []
    for _ in range(2):
        before = trace_counts().get("launch:ssd_intra", 0)
        torch.cuda.synchronize()
        g0 = time.perf_counter()
        gens.append(np.stack(engine.generate(prompts)))
        gen_s.append(time.perf_counter() - g0)
        per_gen.append(trace_counts().get("launch:ssd_intra", 0) - before)
    counts = trace_counts()
    peak = torch.cuda.max_memory_allocated()
    path = {kk: counts.get(f"launch:{kk}", 0) for kk in ("sage_unpack", "sage_fused", "ssd_intra")}
    plain = {kk: v for kk, v in counts.items() if kk.startswith("plain:")}
    assert not plain, f"the lm path ran plain versions on the card: {plain}"
    idle = [kk for kk, n in path.items() if n == 0]
    assert not idle, f"the lm path never launched: {idle}"
    assert per_gen == [cfg.n_layers * sc.max_new] * 2, per_gen
    assert len(prompts) == LM["prompts"] and all(p.size > 0 for p in prompts)
    cpu_store = SageStore(device="cpu", group_blocks=GROUP)
    cpu_store.register("illumina", str(WORK / "illumina.sage2"))
    want = prompts_from_store(cpu_store.session(fused=True), "illumina", **feed)
    assert len(want) == len(prompts) and all(np.array_equal(a, b) for a, b in zip(prompts, want)), \
        "prompts from the card disagree with the plain versions on the CPU"
    out = gens[0]
    assert out.shape == (LM["prompts"], sc.max_new) and out.min() >= 0 and out.max() < cfg.vocab, out
    assert np.array_equal(gens[0], gens[1]), "a second greedy generate gave other tokens"

    # (d) time to first token (prefill of the 8 slots), decode steps, profiles
    toks = torch.as_tensor(slot_tokens(prompts, sc.max_prompt), device=dev)
    logits, cache = lm.prefill(model, cfg, toks)
    assert bool(torch.isfinite(logits.float()).all()), "prefill logits not finite"
    ttft = []
    for _ in range(LM["prefill_runs"]):
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        logits, cache = lm.prefill(model, cfg, toks)
        torch.cuda.synchronize()
        ttft.append((time.perf_counter() - t0) * 1e3)
    cur = torch.argmax(logits[:, -1].float(), dim=-1)[:, None]
    steps = LM["decode_steps"]
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    for t in range(steps):
        lg, cache = lm.decode_step(model, cfg, cur, cache, sc.max_prompt + t)
        cur = torch.argmax(lg[:, -1].float(), dim=-1)[:, None]
    torch.cuda.synchronize()
    dec_s = time.perf_counter() - t0
    assert bool(torch.isfinite(lg.float()).all()), "decode logits not finite"
    first = torch.argmax(logits[:, -1].float(), dim=-1)

    def decode_window(_i):  # decode_step writes into the cache it is given: go on from the timed steps
        tok = first[:, None]
        for t in range(LM["profile_steps"]):
            lg2, _ = lm.decode_step(model, cfg, tok, cache, sc.max_prompt + steps + t)
            tok = torch.argmax(lg2[:, -1].float(), dim=-1)[:, None]
        return tok

    prof = {"prefill": profile_window(lambda _i: lm.prefill(model, cfg, toks), focus="ssd_intra"),
            f"decode_{LM['profile_steps']}_steps": profile_window(decode_window, focus="ssd_intra")}
    del model, cache, logits, lg
    torch.cuda.empty_cache()

    # (b) the card (B6) against the CPU (plain) on a 4-layer cut, same weights
    cut = dataclasses.replace(cfg, n_layers=LM["cut_layers"])
    m_dev = lm.init_params(torch.Generator(device=dev).manual_seed(LM["seed"] + 1), cut, device=dev)
    m_cpu = lm.init_params(torch.Generator().manual_seed(LM["seed"] + 1), cut, device="cpu")
    m_cpu.load_state_dict({kk: v.cpu() for kk, v in m_dev.state_dict().items()})
    rand = np.random.default_rng(LM["seed"]).integers(0, cfg.vocab, (LM["prompts"], sc.max_prompt))
    t_cpu = torch.as_tensor(rand)
    vs_cpu = {}
    for dtype, tol in ((torch.float32, 1e-3), (torch.bfloat16, 5e-2)):
        lg_d, st_d = lm.prefill(m_dev, cut, t_cpu.to(dev), dtype=dtype)
        c0 = time.perf_counter()
        lg_c, st_c = lm.prefill(m_cpu, cut, t_cpu, dtype=dtype)
        name = str(dtype)[6:]
        vs_cpu[name] = {"logits_err": max_abs_err(lg_d.cpu(), lg_c), "tol": tol,
                        "logits_max": float(lg_c.float().abs().max()),
                        "state_err": state_err(st_d["ssm"], st_c["ssm"]), "cpu_seconds": time.perf_counter() - c0}
        assert bool(torch.allclose(lg_d.cpu().float(), lg_c.float(), rtol=tol, atol=tol)), (name, vs_cpu[name])
        if dtype == torch.float32:
            assert vs_cpu[name]["state_err"] <= 1e-3 * (1 + max(float(v.abs().max()) for v in st_c["ssm"].values())), vs_cpu

    # (c) duality at full width on the cut, f32: chunked forward and prefill
    # against step-by-step decode over 160 tokens (a full chunk and a ragged one)
    T = LM["duality_tokens"]
    t2 = torch.as_tensor(rand[:2, :T], device=dev)
    with torch.no_grad():
        full, _ = lm.forward(m_dev, cut, t2, dtype=torch.float32)
    _lg, st_pre = lm.prefill(m_dev, cut, t2, dtype=torch.float32)
    cache = lm.init_cache(cut, batch=2, max_len=T, device=dev)
    outs = []
    for t in range(T):
        lg, cache = lm.decode_step(m_dev, cut, t2[:, t:t + 1], cache, t, dtype=torch.float32)
        outs.append(lg[:, 0])
    dec = torch.stack(outs, dim=1)
    duality = {"logits_err": max_abs_err(dec, full), "state_err": state_err(cache["ssm"], st_pre["ssm"]),
               "tol": 2e-2, "tokens": T}
    assert bool(torch.allclose(dec, full, rtol=2e-2, atol=2e-2)), duality
    assert all(bool(torch.allclose(cache["ssm"][kk], st_pre["ssm"][kk].float(), rtol=2e-2, atol=2e-2))
               for kk in cache["ssm"]), duality
    del m_dev, m_cpu

    n_tok = LM["prompts"] * sc.max_new
    emit("lm", arch=cfg.name, params=n_params, layers=cfg.n_layers, d_model=cfg.d_model,
         ssm_heads=cfg.ssm_heads, state=cfg.ssm_state, chunk=cfg.ssm_chunk, vocab=cfg.vocab,
         kmer_k=k, init_seconds=init_s, prompts=len(prompts), prompt_kmers=[int(p.size) for p in prompts],
         prompt_seconds=prompt_s, max_prompt=sc.max_prompt, max_new=sc.max_new,
         generate_seconds=gen_s, generate_tokens_per_s=[n_tok / g for g in gen_s],
         ssd_launches_per_generate=per_gen, launches=path, plain_calls=plain,
         peak_device_bytes=peak, ttft_ms=ttft, decode_ms_per_step=dec_s / steps * 1e3,
         decode_tokens_per_s=LM["prompts"] * steps / dec_s, first_tokens=out[:, :8].tolist(),
         card_vs_cpu=vs_cpu, duality=duality, profile=prof, seconds=time.perf_counter() - t_phase)
    return path["ssd_intra"], engine


def served_equal(data: dict, direct: dict, what: str) -> None:
    """A served chunk's host arrays equal a direct session read's tensors,
    key for key, dtype and bits (numpy, or a host bf16 tensor for onehot)."""
    assert sorted(data) == sorted(k for k in direct if k != "block_ids"), what
    for k, v in data.items():
        got = v if isinstance(v, torch.Tensor) else torch.from_numpy(np.ascontiguousarray(v))
        want = direct[k].cpu()
        assert got.dtype == want.dtype and torch.equal(got, want), f"{what}: {k} differs from a direct read"


def launches_per_request(before: dict, after: dict, n: int) -> dict:
    return {k: (v - before.get(k, 0)) / n for k, v in after.items() if v != before.get(k, 0)}


def serve_phase(cfg, engine: ServingEngine, oracle: "Oracle") -> dict:
    """The serving frontend on the card: one burst through SageServer over a
    SessionPool of a card store (two-step session, as the batcher runs it)
    and the lm phase's full-width mamba2-370m. Every served read and stream
    chunk against a direct session read and refdec, consensus against
    ``store.consensus_windows``, generates against a direct
    ``engine.generate`` of the same prompts at the same batch; launch counts
    from 0; an A/B of the 64 reads on warm groups, one at a time through
    ``session.read`` against the same through the server; a profiled warm
    server round; a background-thread server with timeouts on every handle."""
    sv = SERVE
    t_phase = time.perf_counter()
    held = torch.cuda.memory_allocated()  # the model and earlier phases' live tensors
    torch.cuda.synchronize()
    torch.cuda.reset_peak_memory_stats()
    store = SageStore(max_prepared=64, group_blocks=GROUP)
    pool = SessionPool(store=store)
    pool.register("illumina", str(WORK / "illumina.sage2"))
    srv = SageServer(pool, engine=engine, max_waiting=128)
    sess = pool.session()
    S, n_rb, k = sv["start"], sv["read_blocks"], pick_k(cfg.vocab)
    reads = [((S + 2 * i, S + 2 * i + n_rb), FMTS[i % 3]) for i in range(sv["reads"])]
    stream_los = [S + sv["stream_blocks"] * (j + 1) for j in range(sv["streams"])]
    gen_blocks = [sv["gen_start"] + GROUP * j for j in range(sv["generates"])]
    cons_ranges = [(S + a, S + b) for a, b in sv["consensus"]]

    # ---- the burst: counts from 0, submitted at once, drained synchronously
    reset_trace_counts()
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    h_reads = [srv.read("illumina", r, f, kmer_k=KMER_K) for r, f in reads]
    h_streams = [srv.stream("illumina", (lo, lo + sv["stream_blocks"]), fmt="kmer", kmer_k=KMER_K,
                            blocks_per_fetch=sv["per_fetch"]) for lo in stream_los]
    h_cons = [srv.consensus("illumina", r) for r in cons_ranges]
    # distinct priorities ahead of everything else: one generate batch, in this order
    h_gens = [srv.generate(dataset="illumina", block_range=(b, b + 1), max_prompt=engine.sc.max_prompt,
                           kmer_k=k, priority=j - sv["generates"]) for j, b in enumerate(gen_blocks)]
    delivered = srv.run_until_idle()
    torch.cuda.synchronize()
    burst_s = time.perf_counter() - t0
    counts = trace_counts()
    stats = dict(srv.batcher.stats)
    plain = {kk: v for kk, v in counts.items() if kk.startswith("plain:")}
    assert not plain, f"the serve path ran plain versions on the card: {plain}"
    path = {kk: counts.get(f"launch:{kk}", 0)
            for kk in ("sage_unpack", "sage_decode", "kmer_pack", "one_hot", "ssd_intra")}
    idle = [kk for kk, n in path.items() if n == 0]
    assert not idle, f"the serve path never launched: {idle}"
    assert stats["generate_batches"] == 1 and stats["isolated_failures"] == 0, stats

    # ---- checks: direct two-step reads, refdec, consensus, the engine
    checked = 0
    for h, (r, f) in zip(h_reads, reads):
        out = h.result(timeout=60)
        assert out is not None, f"read {r} {f} aborted"
        ids = np.arange(*r)
        assert np.array_equal(out["block_ids"], ids), r
        served_equal(out["data"], sess.read("illumina", r, f, kmer_k=KMER_K), f"read {r} {f}")
        checked += oracle.check(out["data"], ids, f"served read {f}")
    for h, lo in zip(h_streams, stream_los):
        chunks = list(h.chunks(timeout=60))
        assert [c["fetch"] for c in chunks] == list(range(sv["stream_blocks"] // sv["per_fetch"])), lo
        assert np.array_equal(np.concatenate([c["block_ids"] for c in chunks]),
                              np.arange(lo, lo + sv["stream_blocks"])), lo
        for c in chunks:
            served_equal(c["data"], sess.read("illumina", c["block_ids"], "kmer", kmer_k=KMER_K), "stream")
            checked += oracle.check(c["data"], c["block_ids"], "served stream")
    for h, r in zip(h_cons, cons_ranges):
        out = h.result(timeout=60)
        wins, starts = store.consensus_windows("illumina", np.arange(*r))
        assert np.array_equal(out["windows"], wins) and np.array_equal(out["starts"], starts), r
    served_tokens = np.stack([h.result(timeout=60)["tokens"] for h in h_gens])
    prompts = [prompts_from_store(sess, "illumina", vocab=cfg.vocab, n_prompts=1,
                                  max_prompt=engine.sc.max_prompt, kmer_k=k, block_range=(b, b + 1))[0]
               for b in gen_blocks]
    direct_tokens = np.stack(engine.generate(prompts))
    assert np.array_equal(served_tokens, direct_tokens), "served generate != direct engine.generate"

    # ---- A/B on warm groups: one at a time through session.read vs the server
    def one_at_a_time(reqs):
        for r, f in reqs:
            out = sess.read("illumina", r, f, kmer_k=KMER_K)
            _host = {kk: v.cpu() for kk, v in out.items() if isinstance(v, torch.Tensor)}

    def through_server(reqs):
        hs = [srv.read("illumina", r, f, kmer_k=KMER_K) for r, f in reqs]
        srv.run_until_idle()
        assert all(h.result(timeout=60) is not None for h in hs)

    ab = {"one_at_a_time": [], "server": []}
    ab_counts = {}
    for name in ("one_at_a_time", "server", "server", "one_at_a_time"):
        fn = one_at_a_time if name == "one_at_a_time" else through_server
        before = trace_counts()
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        fn(reads)
        torch.cuda.synchronize()
        ab[name].append((time.perf_counter() - t0) * 1e3 / len(reads))
        ab_counts[name] = launches_per_request(before, trace_counts(), len(reads))
    few = reads[: sv["profile_reads"]]
    prof = {"warm_server_round": profile_window(lambda _i: through_server(few)),
            "warm_one_at_a_time": profile_window(lambda _i: one_at_a_time(few))}

    # ---- a background-thread server: every handle waited on with a timeout
    bg_reads = reads[: sv["bg_reads"]]
    with SageServer(pool) as bg:
        hs = [bg.read("illumina", r, f, kmer_k=KMER_K) for r, f in bg_reads]
        outs = [h.result(timeout=120) for h in hs]
    for out, (r, f) in zip(outs, bg_reads):
        assert out is not None, f"background read {r} {f} aborted"
        served_equal(out["data"], sess.read("illumina", r, f, kmer_k=KMER_K), f"background read {r} {f}")
    srv.stop()
    peak = torch.cuda.max_memory_allocated()
    emit("serve", requests={"reads": len(reads), "read_blocks": n_rb, "streams": len(stream_los),
                            "stream_blocks": sv["stream_blocks"], "blocks_per_fetch": sv["per_fetch"],
                            "consensus": len(h_cons), "generates": len(h_gens)},
         burst_seconds=burst_s, chunks_delivered=delivered,
         batcher={kk: stats[kk] for kk in ("rounds", "fused_reads", "fused_read_requests", "fused_blocks",
                                           "consensus_calls", "generate_batches", "deferred",
                                           "isp_prefetched_groups", "isp_prefetch_errors")},
         launches=path, plain_calls=plain, blocks_checked_against_refdec=checked,
         generate={"prompts": len(prompts), "prompt_kmers": [int(p.size) for p in prompts],
                   "max_new": engine.sc.max_new, "equal_to_direct_engine": True},
         warm_ms_per_read_request=ab, launches_per_read_request=ab_counts,
         background={"reads": len(bg_reads), "ok": True}, profile=prof,
         held_device_bytes=held, peak_device_bytes=peak, seconds=time.perf_counter() - t_phase)
    return path


def heal_phase(src: SageFile, oracle: "Oracle") -> dict:
    """The self-healing store on the card: an xor parity container of
    full-width Illumina blocks; damage in two parity groups read back
    (two-step and fused) through reconstruction; reads under an in-flight
    EIO / flip plan through the server; a scrubber sweep that repairs the
    medium, an unlimited and a rate-limited sweep, one timed group repair;
    then damage beyond the budget, which fails only the requests that
    touch it. Launch counts from 0."""
    hl = HEAL
    t_phase = time.perf_counter()
    path = WORK / "heal.sage2"
    t0 = time.perf_counter()
    st = write_v2(tile_sage_file(src, hl["tiles"]), path, parity="xor", parity_group=hl["parity_group"])
    write_s = time.perf_counter() - t0
    assert st["dedup_blocks"] == 0 and st["parity"] == "xor", st
    reset_trace_counts()

    # (1) damage within the budget: reconstruction in flight
    corrupt_extents(path, hl["damaged"], byte=7, bit=5)
    store = SageStore(max_prepared=64, group_blocks=GROUP)
    store.register("heal", str(path))
    sess, sess_f = store.session(), store.session(fused=True)
    # untimed: the header open, the codec dictionaries' upload and the first
    # group's pinned staging, so the two timed cold reads differ only in
    # the reconstruction
    warm = sess.read("heal", (2 * GROUP, 3 * GROUP), "kmer", kmer_k=KMER_K)
    oracle.check(warm, warm["block_ids"], "heal warm-up read")
    timed = {}
    for name, gi in (("reconstructed", hl["damaged"][0] // GROUP), ("clean", hl["damaged"][0] // GROUP + 1)):
        rng = (gi * GROUP, (gi + 1) * GROUP)
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        out = sess.read("heal", rng, "kmer", kmer_k=KMER_K)
        torch.cuda.synchronize()
        timed[name] = (time.perf_counter() - t0) * 1e3
        oracle.check(out, out["block_ids"], f"heal {name} read")
    g1 = hl["damaged"][1] // GROUP
    for fmt in FMTS:  # the other damaged group through a fused session (B5)
        out = sess_f.read("heal", (g1 * GROUP, (g1 + 1) * GROUP), fmt, kmer_k=KMER_K)
        oracle.check(out, out["block_ids"], f"heal fused {fmt}")
    recon = store.io_stats["reconstructions"]
    assert recon >= len(hl["damaged"]) and store.health("heal")["ok"], store.io_stats

    # (2) in-flight faults through the server: EIO every 5th read, one flip
    flips = SageStore(max_prepared=64, group_blocks=GROUP)
    flips.register("heal", str(path))
    flips.meta("heal")
    fsrv = SageServer(SessionPool(store=flips))
    fb = hl["flip_block"]
    off = int(SageContainerV2.open(path).extents[fb, 0]) + 3
    lo = fb - fb % GROUP
    freqs = [((lo + 8 * i, lo + 8 * i + 8), FMTS[i % 3]) for i in range(8)]  # two store groups
    with inject(FaultPlan(eio_every=5, flip_offsets={off: 0x01}, flip_times=1)) as plan:
        hs = [fsrv.read("heal", r, f, kmer_k=KMER_K) for r, f in freqs]
        fsrv.run_until_idle()
        outs = [h.result(timeout=60) for h in hs]
    for out, (r, f) in zip(outs, freqs):
        assert out is not None, r
        oracle.check(out["data"], np.arange(*r), f"read under faults {f}")
    fio = flips.io_stats
    faults = {"reads": plan.reads, "eio_raised": plan.eio_raised, "flips": plan.flips,
              **{kk: fio[kk] for kk in ("read_retries", "read_failures", "checksum_retries",
                                        "checksum_failures")}}
    assert plan.eio_raised > 0 and plan.flips == 1 and fio["read_failures"] == 0, faults
    assert fio["checksum_retries"] >= 1 and fsrv.batcher.stats["isolated_failures"] == 0, faults

    # (3) the scrubber repairs the medium; sweeps unlimited and at half rate
    t0 = time.perf_counter()
    res = Scrubber(store, auto_repair=True).run_once("heal")
    repair_sweep_s = time.perf_counter() - t0
    assert res["complete"] and {f["action"] for f in res["findings"]} == {"repaired"}, res
    assert sorted(b for f in res["findings"] for b in f["repaired_blocks"]) == sorted(hl["damaged"])
    fresh = SageContainerV2.open(path)
    assert fresh.verify_blocks() == [] and fresh.verify_parity() == []
    store.evict()
    healed = store.io_stats["reconstructions"]  # the repair's own rebuilds included
    for gi in (hl["damaged"][0] // GROUP, g1):  # the fresh reader's dictionaries re-upload
        out = sess.read("heal", (gi * GROUP, (gi + 1) * GROUP), "onehot")
        oracle.check(out, out["block_ids"], "heal read after repair")
    assert store.io_stats["reconstructions"] == healed, "reads after the repair still reconstructed"
    free = Scrubber(store).run_once("heal")
    limit = free["effective_bps"] / 2
    limited = Scrubber(store, rate_bps=limit).run_once("heal")
    assert free["complete"] and limited["complete"] and not limited["findings"]
    assert limited["effective_bps"] <= 1.2 * limit, (limited, limit)
    rb = hl["repair_block"]
    corrupt_extents(path, [rb], byte=11, bit=2)
    t0 = time.perf_counter()
    summary = store.repair("heal", group=rb // GROUP)
    repair_s = time.perf_counter() - t0
    assert summary["repaired_blocks"] == [rb], summary

    # (4) beyond the budget: two damaged extents in one xor group
    corrupt_extents(path, hl["beyond"], byte=9, bit=6)
    gb = hl["beyond"][0] // GROUP
    bsrv = SageServer(SessionPool(max_prepared=64, group_blocks=GROUP))
    bsrv.pool.register("heal", str(path))
    bad = [((gb * GROUP, gb * GROUP + 4), "2bit"), ((hl["beyond"][0] - 2, hl["beyond"][0] + 2), "kmer")]
    ok = [(((gb - 1) * GROUP, (gb - 1) * GROUP + 4), "2bit"), (((gb + 1) * GROUP, (gb + 1) * GROUP + 4), "kmer"),
          (((gb + 2) * GROUP, (gb + 2) * GROUP + 4), "onehot")]
    h_bad = [bsrv.read("heal", r, f, kmer_k=KMER_K) for r, f in bad]
    h_ok = [bsrv.read("heal", r, f, kmer_k=KMER_K) for r, f in ok]
    bsrv.run_until_idle()
    for h in h_bad:
        try:
            h.result(timeout=60)
        except IntegrityError as e:
            assert e.block_group == gb, e
        else:
            raise AssertionError("a request on damage beyond the parity budget was served")
    for h, (r, f) in zip(h_ok, ok):
        out = h.result(timeout=60)
        assert out is not None, r
        oracle.check(out["data"], np.arange(*r), f"healthy read beside quarantine {f}")
    bst = bsrv.batcher.stats
    assert bst["isolated_failures"] == len(bad) and bst["auto_repairs"] == 0 and bst["repair_attempts"] >= 1, bst
    assert gb in bsrv.health("heal")["quarantined_groups"]
    for s in (fsrv, bsrv):
        s.stop()
    counts = trace_counts()
    plain = {kk: v for kk, v in counts.items() if kk.startswith("plain:")}
    assert not plain, f"the heal path ran plain versions on the card: {plain}"
    launches = {kk: counts.get(f"launch:{kk}", 0)
                for kk in ("sage_unpack", "sage_decode", "sage_fused", "kmer_pack", "one_hot")}
    assert all(n > 0 for kk, n in launches.items() if kk != "one_hot"), launches
    emit("heal", blocks=st["n_blocks"], parity=f"xor/{hl['parity_group']}", container_bytes=st["file_nbytes"],
         crc32c="C extension" if hasattr(layout, "_crc32c_c") else "python (no google_crc32c)",
         parity_overhead=st["parity_overhead"], write_seconds=write_s,
         damaged_blocks=list(hl["damaged"]), reconstructions=recon, read_ms=timed,
         faults=faults, scrub={"repair_sweep_seconds": repair_sweep_s,
                               "findings": [{kk: f[kk] for kk in ("group", "blocks", "action")}
                                            for f in res["findings"]],
                               "unlimited_bps": free["effective_bps"], "limit_bps": limit,
                               "limited_bps": limited["effective_bps"],
                               "bytes_scanned": free["bytes_scanned"], "unlimited_seconds": free["elapsed_s"],
                               "limited_seconds": limited["elapsed_s"]},
         repair_one_group_seconds=repair_s, repair_summary=summary,
         beyond_budget={"quarantined_group": gb, "failed_requests": len(bad), "served_requests": len(ok),
                        **{kk: bst[kk] for kk in ("repair_attempts", "auto_repairs", "isolated_failures")}},
         launches=launches, plain_calls=plain, seconds=time.perf_counter() - t_phase)
    return launches


def train_phase(dev, cfg, src: SageFile, oracle: "Oracle") -> int:
    """mamba2-370m at full width trained on the card through the port's
    Trainer: 8 steps of 8 x 512 k-mer tokens (k = 7) from a fused
    SageTokenPipeline over Illumina tiles no earlier phase touched, remat
    on, bf16 activations, a checkpoint at step 4. Checks: every batch
    against refdec's k-mer stream, every loss finite and the last below the
    first, launch counts from 0 (B6 forward twice a layer a step, its
    backward once, B1 and B5 from the pipeline, no plain call); the run's
    step-4 checkpoint restored into a fresh Trainer and pipeline gives the
    same batches and, within TRAIN["resume_rtol"], the same losses for
    steps 5-8; a 2-layer full-width cut's step on the card against the CPU
    (tests/train_cases.py). Reports step ms, tokens/s, peak memory, the
    checkpoint's bytes, and a profile of one step. Returns B6 backward's
    launches on the path."""
    tr = TRAIN
    t_phase = time.perf_counter()
    n_src = src.meta.n_blocks
    path = WORK / "train.sage2"
    write_v2(tile_sage_file(src, tr["tiles"], first=tr["first_tile"]), path)
    ckdir = WORK / "train_ckpt"
    k = pick_k(cfg.vocab)
    opts = TrainOptions(adamw=AdamWConfig(lr=tr["lr"], warmup_steps=tr["warmup"], total_steps=tr["steps"]))
    need = tr["batch"] * (tr["seq"] + 1)

    def trainer(seed: int, keep_last: int):
        """A fresh model, store, pipeline and Trainer; the batches it takes
        are kept in ``seen``."""
        store = SageStore(group_blocks=GROUP)
        store.register("train", str(path))
        pipe = SageTokenPipeline("train", cfg.vocab, tr["batch"], tr["seq"], store=store)
        assert pipe.k == k
        seen = []

        def tap(it):
            for b in it:
                seen.append(b)
                yield b

        model, opt = init_train_state(torch.Generator(device=dev).manual_seed(seed), cfg, opts, device=dev)
        tc = TrainerConfig(total_steps=tr["steps"], ckpt_every=tr["ckpt_at"], log_every=1,
                           ckpt_dir=str(ckdir), keep_last=keep_last)
        return Trainer(tc, cfg, opts, model, opt, tap(pipe.batches())), pipe, seen

    # (a) the run: counts from 0, 8 steps, checkpoints at 4 and 8
    t1, pipe, seen = trainer(tr["seed"], keep_last=2)
    n_params = sum(p.numel() for p in t1.model.parameters())
    torch.cuda.synchronize()
    torch.cuda.reset_peak_memory_stats()
    reset_trace_counts()
    t0 = time.perf_counter()
    with contextlib.redirect_stdout(io.StringIO()):
        hist = t1.run(pipeline=pipe)
    run_s = time.perf_counter() - t0
    counts = trace_counts()
    peak = torch.cuda.max_memory_allocated()
    losses = [h["loss"] for h in hist]
    step_ms = [h["dt"] * 1e3 for h in hist]
    L, S = cfg.n_layers, tr["steps"]
    path_n = {kk: counts.get(f"launch:{kk}", 0) for kk in ("sage_unpack", "sage_fused", "ssd_intra", "ssd_intra_bwd")}
    plain = {kk: v for kk, v in counts.items() if kk.startswith("plain:")}
    assert not plain, f"the train path ran plain versions on the card: {plain}"
    assert path_n["sage_unpack"] > 0 and path_n["sage_fused"] > 0, path_n
    assert (path_n["ssd_intra"], path_n["ssd_intra_bwd"]) == (2 * L * S, L * S), path_n
    assert len(losses) == S and all(np.isfinite(losses)), losses
    assert losses[-1] < losses[0], f"training did not reduce the loss: {losses}"
    base = tr["first_tile"] * n_src  # the train container's block j is block base + j of the layout
    kpb = [oracle.rows[source_block(base + j, n_src)].size // k for j in range(tr["tiles"] * n_src)]
    n_blocks = int(np.searchsorted(np.cumsum(kpb), len(seen) * need)) + 1
    flat = oracle.kmer_stream(np.arange(n_blocks) + base, k)
    for i, b in enumerate(seen):
        want = flat[i * need:(i + 1) * need].reshape(tr["batch"], tr["seq"] + 1)
        assert np.array_equal(b["tokens"], want[:, :-1]) and np.array_equal(b["labels"], want[:, 1:]), \
            f"train batch {i} disagrees with refdec's k-mer stream"
    t1.ckpt.wait()
    ck_bytes = sum(f.stat().st_size for f in (ckdir / f"step_{tr['ckpt_at']}").iterdir())

    # one more step of the run, profiled (after the checks: it moves the model on)
    def one_step_of_run(_i):
        b = {kk: torch.as_tensor(v).to(dev) for kk, v in next(t1.data).items()}
        return t1.step_fn(t1.model, t1.opt, b)[2]["loss"]

    prof = profile_window(one_step_of_run, focus="ssd", kernels=("ssd_bwd",))
    del t1
    torch.cuda.empty_cache()

    # (b) the run lost after its step-4 checkpoint: a fresh trainer and
    # pipeline (other initial weights) resume from it and run steps 5-8
    shutil.rmtree(ckdir / f"step_{S}")
    t2, pipe2, seen2 = trainer(tr["seed"] + 1, keep_last=1)
    t0 = time.perf_counter()
    assert t2.maybe_resume(pipe2) and t2.step == tr["ckpt_at"] and int(t2.opt["step"]) == tr["ckpt_at"]
    resume_s = time.perf_counter() - t0
    with contextlib.redirect_stdout(io.StringIO()):
        hist2 = t2.run(pipeline=pipe2)
    again = [h["loss"] for h in hist2]
    assert [h["step"] for h in hist2] == list(range(tr["ckpt_at"] + 1, S + 1)), hist2
    for b, ref_b in zip(seen2, seen[tr["ckpt_at"]:S]):
        assert all(np.array_equal(b[kk], ref_b[kk]) for kk in ("tokens", "labels")), "a resumed batch differs"
    resume_err = max(abs(a - b) / abs(b) for a, b in zip(again, losses[tr["ckpt_at"]:]))
    assert resume_err <= tr["resume_rtol"], (again, losses)
    del t2
    torch.cuda.empty_cache()

    # (c) a 2-layer full-width cut: one step on the card against the CPU
    cut, m_dev, m_cpu = cut_models(cfg, tr["cut_layers"], dev, seed=tr["seed"] + 2)
    cb = cut_batch(cut, tr["cut_batch"], tr["seq"], seed=tr["seed"])
    c0 = time.perf_counter()
    vs_cpu = compare_step(one_step(cut, m_dev, cb, dev), one_step(cut, m_cpu, cb, "cpu"), dev)
    vs_cpu["seconds"] = time.perf_counter() - c0
    del m_dev, m_cpu

    tok = tr["batch"] * tr["seq"]
    steady = sorted(step_ms[1:])[len(step_ms[1:]) // 2]
    emit("train", arch=cfg.name, params=n_params, layers=L, d_model=cfg.d_model, vocab=cfg.vocab, kmer_k=k,
         batch=tr["batch"], seq=tr["seq"], steps=S, remat="nothing", dtype="bfloat16",
         blocks=[tr["first_tile"] * n_src, (tr["first_tile"] + tr["tiles"]) * n_src],
         losses=losses, resumed_losses=again, resume_max_rel_err=resume_err, resume_rtol=tr["resume_rtol"],
         resume_seconds=resume_s, step_ms=step_ms, median_step_ms_after_first=steady,
         tokens_per_s=tok / (steady / 1e3), run_seconds=run_s, checkpoint_bytes=ck_bytes,
         launches=path_n, launches_per_step={kk: v / S for kk, v in path_n.items()}, plain_calls=plain,
         batches_checked_against_refdec=len(seen), peak_device_bytes=peak, profile_step=prof,
         card_vs_cpu=vs_cpu, seconds=time.perf_counter() - t_phase)
    shutil.rmtree(ckdir)
    return path_n["ssd_intra_bwd"]


def sdpa(q, k, v):
    """One ``F.scaled_dot_product_attention`` call (causal, GQA) on (B, S,
    H, Dh) tensors: the library's attention, timed as a yardstick only."""
    o = torch.nn.functional.scaled_dot_product_attention(
        q.transpose(1, 2), k.transpose(1, 2), v.transpose(1, 2), is_causal=True, enable_gqa=True)
    return o.transpose(1, 2)


def attention_yardstick(cfg, dev, seed: int) -> dict:
    """The port's attention (``causal_flash``: plain torch ops, f32 scores)
    at the train shape (8 x 512 tokens, bf16 q, k, v, causal, GQA, one KV
    block as TrainOptions' chunk 1024 gives) beside one
    ``scaled_dot_product_attention`` call on the same tensors: device ms of
    the forward and of forward + backward, the outputs' max abs difference
    (bf16 tolerance 5e-2), and the bound: q, k, v (and dout) read once, the
    outputs written once, over HBM_BYTES_PER_S; the causal products (QKᵀ
    and PV forward, five more backward, each S(S+1)/2·Dh multiply-adds a
    head) over BF16_OPS_PER_S."""
    run = FAMILY_RUN
    B, S, H, KV, Dh = run["batch"], run["seq"], cfg.n_heads, cfg.n_kv_heads, cfg.head_dim
    g = torch.Generator(device=dev).manual_seed(seed)
    q, k, v, dout = (torch.randn(shape, generator=g, device=dev).to(torch.bfloat16)
                     for shape in ((B, S, H, Dh), (B, S, KV, Dh), (B, S, KV, Dh), (B, S, H, Dh)))
    out, lib = LAYERS.causal_flash(q, k, v, 1024), sdpa(q, k, v)
    err = max_abs_err(out, lib)
    assert bool(torch.allclose(out.float(), lib.float(), rtol=5e-2, atol=5e-2)), err
    qg, kg, vg = (t.clone().requires_grad_() for t in (q, k, v))

    def flash_fb():
        return torch.autograd.grad(LAYERS.causal_flash(qg, kg, vg, 1024), (qg, kg, vg), dout)

    def sdpa_fb():
        return torch.autograd.grad(sdpa(qg, kg, vg), (qg, kg, vg), dout)

    io = B * S * (H + 2 * KV) * Dh * 2 + B * S * H * Dh * 2
    macs = B * H * Dh * S * (S + 1) // 2  # one causal product
    it = run["attn_iters"]
    fwd_ms, fb_ms = cuda_ms(lambda: LAYERS.causal_flash(q, k, v, 1024), it)[0], cuda_ms(flash_fb, it)[0]
    b_f, by_f = bound(io, 2 * 2 * macs, BF16_OPS_PER_S)
    b_fb, by_fb = bound(2 * io, 7 * 2 * macs, BF16_OPS_PER_S)
    return {"shape": [B, S, H, KV, Dh], "max_abs_err_vs_sdpa": err,
            "fwd": {"ms": fwd_ms, "sdpa_ms": cuda_ms(lambda: sdpa(q, k, v), it)[0], "bound_ms": b_f, "bound_by": by_f},
            "fwd_bwd": {"ms": fb_ms, "sdpa_ms": cuda_ms(sdpa_fb, it)[0], "bound_ms": b_fb, "bound_by": by_fb}}


def family_phase(dev, kind: str, src: SageFile, oracle: "Oracle") -> dict:
    """A dense (qwen2-1.5b), hybrid (zamba2-2.7b) or moe (deepseek-moe-16b)
    LM at full width on the card, weights from a seeded generator (the moe
    model cut in depth: ``serve_layers`` served, ``train_layers`` trained):

    (a) serving: 8 prompts from an Illumina block through a fused kmer
        session of a store of its own (B1, B5), two greedy generate calls
        (the hybrid: B6 once a Mamba2 layer a step), held against the CPU's
        prompts and each other; TTFT, decode ms a step, tokens/s, peak
        memory, profiles of a prefill and 4 decode steps with the device
        time inside the attention (and inside ``moe_apply``); the moe
        family's share of (token, choice) pairs its prefill dropped;
    (b) a depth cut against the CPU: f32 and bf16 prefill logits and the
        cache of 2 prompts of 512 tokens (the moe family's card routed as
        the CPU was, every difference a near tie, and the share of
        decisions that agreed);
    (c) the duality on the cut (f32): step-by-step decode against the
        chunked forward, and its cache against a chunked prefill's (the
        moe family at capacity_factor = n_experts / top_k, which drops no
        pair: a prefill at the default factor may drop pairs that one-token
        decode steps keep);
    (d) training through the Trainer (no checkpoint) on a fused
        SageTokenPipeline: every batch against refdec's k-mer stream, the
        loss falls, launch counts from 0 (the hybrid: B6 forward twice a
        Mamba2 layer a step, backward once); step ms, tokens/s, peak
        memory, a profiled step (busy share, top device ops, attention,
        ``moe_apply``); the moe family's aux loss each step;
    (e) a depth cut's train step (f32) against the CPU within
        tests/train_cases.py's bounds (the moe family's card routed as the
        CPU was);
    (f) the attention beside scaled_dot_product_attention at the train
        shape.
    Returns the launches of the serving and training paths."""
    spec, run = FAMILY[kind], FAMILY_RUN
    t_phase = time.perf_counter()
    parts, t_part = {}, [t_phase]

    def part(name: str) -> None:  # seconds since the previous part ended
        now = time.perf_counter()
        parts[name] = now - t_part[0]
        t_part[0] = now
    whole = get_arch(spec["arch"])
    cfg = dataclasses.replace(whole, n_layers=spec.get("serve_layers", whole.n_layers))
    moe = cfg.family == "moe"
    n_ssm = cfg.n_layers if cfg.family == "hybrid" else 0
    focus = "ssd" if n_ssm else ""
    attn = [(LAYERS, "attention_train"), (LAYERS, "_flash_fwd_impl")]
    # moe_apply and its parts: the router, the dispatch and within it the expert products
    experts = [(MOE, "moe_apply"), (MOE, "route"), (MOE, "_dispatch_ffn"), (MOE, "_expert_ffn")] if moe else []

    # (a) serving
    t0 = time.perf_counter()
    model = lm.init_params(torch.Generator(device=dev).manual_seed(spec["seed"]), cfg, device=dev)
    torch.cuda.synchronize()
    init_s = time.perf_counter() - t0
    n_params = sum(p.numel() for p in model.parameters())
    k = pick_k(cfg.vocab)
    sc = ServeConfig()
    engine = ServingEngine(cfg, model, sc)
    store = SageStore(max_prepared=4, group_blocks=GROUP)
    store.register("illumina", str(WORK / "illumina.sage2"))
    feed = dict(vocab=cfg.vocab, n_prompts=run["prompts"], max_prompt=sc.max_prompt, kmer_k=k,
                block_range=(spec["prompt_block"], spec["prompt_block"] + 1))
    torch.cuda.synchronize()
    torch.cuda.reset_peak_memory_stats()
    reset_trace_counts()
    t0 = time.perf_counter()
    prompts = prompts_from_store(store.session(fused=True), "illumina", **feed)
    prompt_s = time.perf_counter() - t0
    gens, gen_s, per_gen = [], [], []
    for _ in range(2):
        before = trace_counts().get("launch:ssd_intra", 0)
        torch.cuda.synchronize()
        g0 = time.perf_counter()
        gens.append(np.stack(engine.generate(prompts)))
        gen_s.append(time.perf_counter() - g0)
        per_gen.append(trace_counts().get("launch:ssd_intra", 0) - before)
    counts = trace_counts()
    serve_peak = torch.cuda.max_memory_allocated()
    serve_n = {kk: counts.get(f"launch:{kk}", 0) for kk in ("sage_unpack", "sage_fused") + ("ssd_intra",) * bool(n_ssm)}
    plain = {kk: v for kk, v in counts.items() if kk.startswith("plain:")}
    assert not plain, f"the {kind} serving path ran plain versions on the card: {plain}"
    assert all(serve_n.values()), f"the {kind} serving path never launched: {serve_n}"
    assert per_gen == [n_ssm * sc.max_new] * 2, per_gen
    assert len(prompts) == run["prompts"] and all(p.size > 0 for p in prompts)
    cpu_store = SageStore(device="cpu", group_blocks=GROUP)
    cpu_store.register("illumina", str(WORK / "illumina.sage2"))
    want = prompts_from_store(cpu_store.session(fused=True), "illumina", **feed)
    assert len(want) == len(prompts) and all(np.array_equal(a, b) for a, b in zip(prompts, want)), \
        "prompts from the card disagree with the plain versions on the CPU"
    out = gens[0]
    assert out.shape == (run["prompts"], sc.max_new) and out.min() >= 0 and out.max() < cfg.vocab, out
    assert np.array_equal(gens[0], gens[1]), "a second greedy generate gave other tokens"

    steps = run["decode_steps"]
    max_len = sc.max_prompt + steps + run["profile_steps"] + 1  # room for the profiled steps after the timed ones
    toks = torch.as_tensor(slot_tokens(prompts, sc.max_prompt), device=dev)
    logits, cache = lm.prefill(model, cfg, toks, max_len)
    ttft = []
    for _ in range(run["prefill_runs"]):
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        logits, cache = lm.prefill(model, cfg, toks, max_len)
        torch.cuda.synchronize()
        ttft.append((time.perf_counter() - t0) * 1e3)
    assert bool(torch.isfinite(logits.float()).all()), "prefill logits not finite"
    first = torch.argmax(logits[:, -1].float(), dim=-1)[:, None]
    cur = first
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    for t in range(steps):
        lg, cache = lm.decode_step(model, cfg, cur, cache, sc.max_prompt + t)
        cur = torch.argmax(lg[:, -1].float(), dim=-1)[:, None]
    torch.cuda.synchronize()
    dec_s = time.perf_counter() - t0
    assert bool(torch.isfinite(lg.float()).all()), "decode logits not finite"

    def decode_window(_i):  # decode_step writes into the cache it is given: go on after the timed steps
        tok = first
        for t in range(run["profile_steps"]):
            lg2, _ = lm.decode_step(model, cfg, tok, cache, sc.max_prompt + steps + t)
            tok = torch.argmax(lg2[:, -1].float(), dim=-1)[:, None]
        return tok

    serve_prof = {
        "prefill": profile_window(lambda _i: lm.prefill(model, cfg, toks, max_len), focus=focus,
                                  ranges=attn + experts),
        f"decode_{run['profile_steps']}_steps": profile_window(decode_window, focus=focus,
                                                               ranges=[(LAYERS, "attention_decode")] + experts)}
    routed = []
    if moe:  # the pairs the serving prefill dropped past capacity, every layer
        with recorded(routed):
            lm.prefill(model, cfg, toks, max_len)
    dropped = dropped_share(routed, cfg) if moe else None
    del model, engine, cache, logits, lg, routed
    torch.cuda.empty_cache()
    part("serve")

    # (b) the depth cut against the CPU, same weights
    cut = dataclasses.replace(cfg, n_layers=spec["cut_layers"])
    m_dev = lm.init_params(torch.Generator(device=dev).manual_seed(spec["seed"] + 1), cut, device=dev)
    m_cpu = copy.deepcopy(m_dev).to("cpu")
    rand = np.random.default_rng(spec["seed"]).integers(0, cfg.vocab, (run["cpu_prompts"], sc.max_prompt))
    t_cpu = torch.as_tensor(rand)
    vs_cpu = {}
    for dtype, tol in ((torch.float32, 1e-3), (torch.bfloat16, 5e-2)):
        log, routing = [], {}
        c0 = time.perf_counter()
        with recorded(log) if moe else contextlib.nullcontext():
            lg_c, c_c = lm.prefill(m_cpu, cut, t_cpu, dtype=dtype)
        cpu_s = time.perf_counter() - c0
        with replayed(log, routing) if moe else contextlib.nullcontext():
            lg_d, c_d = lm.prefill(m_dev, cut, t_cpu.to(dev), dtype=dtype)
        name = str(dtype)[6:]
        kv_err = max(max_abs_err(c_d[kk].cpu(), c_c[kk]) for kk in ("k", "v"))
        vs_cpu[name] = {"logits_err": max_abs_err(lg_d.cpu(), lg_c), "tol": tol, "kv_err": kv_err,
                        "logits_max": float(lg_c.float().abs().max()), "cpu_seconds": cpu_s}
        if moe:
            vs_cpu[name]["routing"] = {**routing, "agreed_share": routing["agreed"] / routing["decisions"],
                                       "dropped_share": dropped_share(log, cut)}
        if "ssm" in c_c:
            vs_cpu[name]["state_err"] = state_err(c_d["ssm"], c_c["ssm"])
        assert bool(torch.allclose(lg_d.cpu().float(), lg_c.float(), rtol=tol, atol=tol)), (name, vs_cpu[name])
        if dtype == torch.float32:
            for kk in ("k", "v"):
                assert bool(torch.allclose(c_d[kk].cpu(), c_c[kk], rtol=tol, atol=tol)), (kk, vs_cpu[name])
            if "ssm" in c_c:
                assert vs_cpu[name]["state_err"] <= tol * (1 + max(float(v.abs().max()) for v in c_c["ssm"].values())), vs_cpu
    del m_cpu
    part("cut_vs_cpu")

    # (c) duality on the cut, f32: chunked forward and prefill (KV blocks of
    # 40 of 160 tokens) against step-by-step decode
    T = run["duality_tokens"]
    t2 = torch.as_tensor(rand[:, :T], device=dev)
    if moe:
        cut = dataclasses.replace(cut, capacity_factor=cut.n_experts / cut.moe_top_k)
    with torch.no_grad():
        full, _ = lm.forward(m_dev, cut, t2, chunk=run["duality_chunk"], dtype=torch.float32)
    _lg, pre = lm.prefill(m_dev, cut, t2, T, chunk=run["duality_chunk"], dtype=torch.float32)
    dcache = lm.init_cache(cut, batch=t2.shape[0], max_len=T, dtype=torch.float32, device=dev)
    outs = []
    for t in range(T):
        lg, dcache = lm.decode_step(m_dev, cut, t2[:, t:t + 1], dcache, t, dtype=torch.float32)
        outs.append(lg[:, 0])
    dec = torch.stack(outs, dim=1)
    duality = {"logits_err": max_abs_err(dec, full), "kv_err": max(max_abs_err(dcache[kk], pre[kk]) for kk in ("k", "v")),
               "tol": 2e-2, "tokens": T, "chunk": LAYERS._pick_chunk(T, run["duality_chunk"]),
               "capacity_factor": cut.capacity_factor if moe else None}
    assert bool(torch.allclose(dec, full, rtol=2e-2, atol=2e-2)), duality
    assert all(bool(torch.allclose(dcache[kk], pre[kk], rtol=2e-2, atol=2e-2)) for kk in ("k", "v")), duality
    if "ssm" in pre:
        duality["state_err"] = state_err(dcache["ssm"], pre["ssm"])
        assert all(bool(torch.allclose(dcache["ssm"][kk], pre["ssm"][kk].float(), rtol=2e-2, atol=2e-2))
                   for kk in pre["ssm"]), duality
    del m_dev, dcache, pre, full
    torch.cuda.empty_cache()
    part("duality")

    # (d) training: the Trainer over a fused pipeline on tiles of their own
    cfg = dataclasses.replace(whole, n_layers=spec.get("train_layers", whole.n_layers))
    n_src = src.meta.n_blocks
    data = WORK / f"{kind}_train.sage2"
    write_v2(tile_sage_file(src, run["tiles"], first=spec["first_tile"]), data)
    S_ = spec["steps"]
    opts = TrainOptions(adamw=AdamWConfig(lr=run["lr"], warmup_steps=run["warmup"], total_steps=S_))
    tstore = SageStore(group_blocks=GROUP)
    tstore.register("train", str(data))
    pipe = SageTokenPipeline("train", cfg.vocab, run["batch"], run["seq"], store=tstore)
    assert pipe.k == k
    seen = []

    def tap(it):
        for b in it:
            seen.append(b)
            yield b

    class NoSaveTrainer(Trainer):  # no checkpoint at full width (~18 GB for qwen2, ~28 GB for zamba2)
        def _save(self, pipeline, block: bool = False) -> None:
            pass

    model, opt = init_train_state(torch.Generator(device=dev).manual_seed(spec["seed"] + 2), cfg, opts, device=dev)
    tc = TrainerConfig(total_steps=S_, ckpt_every=S_ + 1, log_every=1, ckpt_dir=str(WORK / f"{kind}_ckpt"))
    trainer = NoSaveTrainer(tc, cfg, opts, model, opt, tap(pipe.batches()))
    train_params = sum(p.numel() for p in model.parameters())
    auxes = []
    step_fn = trainer.step_fn

    def step_and_aux(*a):  # keeps each step's aux loss (a 0-d tensor; read after the run)
        out = step_fn(*a)
        auxes.append(out[2]["aux"])
        return out

    trainer.step_fn = step_and_aux
    torch.cuda.synchronize()
    torch.cuda.reset_peak_memory_stats()
    reset_trace_counts()
    t0 = time.perf_counter()
    with contextlib.redirect_stdout(io.StringIO()):
        hist = trainer.run(pipeline=pipe)
    run_s = time.perf_counter() - t0
    counts = trace_counts()
    train_peak = torch.cuda.max_memory_allocated()
    losses = [h["loss"] for h in hist]
    step_ms = [h["dt"] * 1e3 for h in hist]
    train_n = {kk: counts.get(f"launch:{kk}", 0) for kk in ("sage_unpack", "sage_fused", "ssd_intra", "ssd_intra_bwd")}
    plain = {kk: v for kk, v in counts.items() if kk.startswith("plain:")}
    assert not plain, f"the {kind} train path ran plain versions on the card: {plain}"
    assert train_n["sage_unpack"] > 0 and train_n["sage_fused"] > 0, train_n
    assert (train_n["ssd_intra"], train_n["ssd_intra_bwd"]) == (2 * n_ssm * S_, n_ssm * S_), train_n
    assert len(losses) == S_ and all(np.isfinite(losses)), losses
    assert losses[-1] < losses[0], f"training did not reduce the loss: {losses}"
    aux = [float(a) for a in auxes]
    assert all(np.isfinite(aux)) and (min(aux) > 0) == moe, aux

    def one_step_of_run(_i):  # one more step of the run (after the checks of its losses: it moves the model on)
        b = {kk: torch.as_tensor(v).to(dev) for kk, v in next(trainer.data).items()}
        return trainer.step_fn(trainer.model, trainer.opt, b)[2]["loss"]

    train_prof = profile_window(one_step_of_run, focus=focus, ranges=attn + [(LAYERS, "_flash_bwd")] + experts,
                               kernels=("ssd_bwd",))
    need = run["batch"] * (run["seq"] + 1)
    base = spec["first_tile"] * n_src
    kpb = [oracle.rows[source_block(base + j, n_src)].size // k for j in range(run["tiles"] * n_src)]
    n_blocks = int(np.searchsorted(np.cumsum(kpb), len(seen) * need)) + 1
    flat = oracle.kmer_stream(np.arange(n_blocks) + base, k)
    for i, b in enumerate(seen):  # the run's batches and the two profiled steps'
        want = flat[i * need:(i + 1) * need].reshape(run["batch"], run["seq"] + 1)
        assert np.array_equal(b["tokens"], want[:, :-1]) and np.array_equal(b["labels"], want[:, 1:]), \
            f"{kind} train batch {i} disagrees with refdec's k-mer stream"
    del trainer, model, opt
    torch.cuda.empty_cache()
    part("train")

    # (e) a depth cut's train step (f32 activations) against the CPU
    cut2, c_dev, c_cpu = cut_models(cfg, spec["train_cut_layers"], dev, seed=spec["seed"] + 3)
    cb = cut_batch(cut2, run["cut_batch"], run["cut_seq"], seed=spec["seed"])
    log, routing = [], {}
    c0 = time.perf_counter()
    with recorded(log) if moe else contextlib.nullcontext():
        on_cpu = one_step(cut2, c_cpu, cb, "cpu")
    c1 = time.perf_counter()
    with replayed(log, routing) if moe else contextlib.nullcontext():
        on_card = one_step(cut2, c_dev, cb, dev)
    c2 = time.perf_counter()
    step_vs_cpu = compare_step(on_card, on_cpu, dev)
    step_vs_cpu.update(seconds=time.perf_counter() - c0, card_step_seconds=c2 - c1, cpu_step_seconds=c1 - c0,
                       compare_seconds=time.perf_counter() - c2)
    if moe:
        step_vs_cpu["routing"] = {**routing, "agreed_share": routing["agreed"] / routing["decisions"]}
    del c_dev, c_cpu, on_card, on_cpu
    torch.cuda.empty_cache()
    part("train_cut_vs_cpu")

    # (f) the attention beside scaled_dot_product_attention
    yard = attention_yardstick(cfg, dev, spec["seed"] + 4)
    torch.cuda.empty_cache()
    part("attention_yardstick")

    n_tok = run["prompts"] * sc.max_new
    tok = run["batch"] * run["seq"]
    steady = sorted(step_ms[1:])[len(step_ms[1:]) // 2]
    moe_shape = {"experts": cfg.n_experts, "top_k": cfg.moe_top_k, "expert_d_ff": cfg.expert_d_ff,
                 "shared": cfg.n_shared_experts, "capacity_factor": whole.capacity_factor} if moe else None
    emit(kind, arch=cfg.name, family=cfg.family, params=n_params, layers=whole.n_layers,
         serve_layers=spec.get("serve_layers", whole.n_layers), train_layers=cfg.n_layers, d_model=cfg.d_model,
         heads=[cfg.n_heads, cfg.n_kv_heads, cfg.head_dim], d_ff=cfg.d_ff, vocab=cfg.vocab, moe=moe_shape, kmer_k=k,
         init_seconds=init_s,
         serve={"prompts": len(prompts), "prompt_kmers": [int(p.size) for p in prompts], "prompt_seconds": prompt_s,
                "max_prompt": sc.max_prompt, "max_new": sc.max_new, "generate_seconds": gen_s,
                "generate_tokens_per_s": [n_tok / g for g in gen_s], "ssd_launches_per_generate": per_gen,
                "launches": serve_n, "peak_device_bytes": serve_peak, "ttft_ms": ttft,
                "decode_ms_per_step": dec_s / steps * 1e3, "decode_tokens_per_s": run["prompts"] * steps / dec_s,
                "first_tokens": out[:, :8].tolist(), "prefill_dropped_share": dropped, "profile": serve_prof},
         card_vs_cpu={"cut_layers": spec["cut_layers"], "prompts": run["cpu_prompts"], **vs_cpu},
         duality=duality,
         train={"params": train_params, "batch": run["batch"], "seq": run["seq"], "steps": S_, "remat": "nothing",
                "dtype": "bfloat16", "aux": aux,
                "blocks": [base, base + run["tiles"] * n_src], "losses": losses, "step_ms": step_ms,
                "median_step_ms_after_first": steady, "tokens_per_s": tok / (steady / 1e3), "run_seconds": run_s,
                "launches": train_n, "launches_per_step": {kk: v / S_ for kk, v in train_n.items()},
                "batches_checked_against_refdec": len(seen), "peak_device_bytes": train_peak,
                "profile_step": train_prof},
         train_step_vs_cpu={"cut_layers": spec["train_cut_layers"], "batch": [run["cut_batch"], run["cut_seq"]],
                            **step_vs_cpu},
         attention=yard, part_seconds=parts, seconds=time.perf_counter() - t_phase)
    shutil.rmtree(WORK / f"{kind}_ckpt", ignore_errors=True)
    return {"serve": serve_n, "train": train_n}


def main() -> None:
    t_start = time.perf_counter()
    # ---- device -----------------------------------------------------------
    if not torch.cuda.is_available():
        print("chip_smoke: torch.cuda.is_available() is false; this run needs an NVIDIA GPU",
              file=sys.stderr)
        sys.exit(1)
    dev = torch.device("cuda")
    card = smi()
    props = torch.cuda.get_device_properties(dev)
    emit("device", name=torch.cuda.get_device_name(0), smi=card, sms=props.multi_processor_count,
         torch=torch.__version__, cuda=torch.version.cuda, int32_ops_per_s=int32_ops_per_s())

    # ---- build ------------------------------------------------------------
    t0 = time.perf_counter()
    info = cuda_lib.build_all()
    emit("build", seconds=time.perf_counter() - t0,
         libs={k: {"built": v["built"],
                   "ptxas": [ln.strip() for ln in v["log"].splitlines() if "registers" in ln or "spill" in ln]}
               for k, v in info.items()})

    # ---- data -------------------------------------------------------------
    if WORK.exists():
        shutil.rmtree(WORK)
    WORK.mkdir(parents=True)
    t0 = time.perf_counter()
    ill = ILLUMINA
    ref_ill = make_reference(ill["ref_len"], seed=ill["ref_seed"])
    rs = sample_read_set(ref_ill, "illumina", depth=ill["depth"], seed=ill["seed"])
    src = SageEncoder(ref_ill, token_target=ill["token_target"], batched=False).encode(rs)
    t_enc = time.perf_counter() - t0
    assert (src.meta.n_blocks, src.meta.caps.tokens) == (ill["blocks"], ill["tokens"]), src.meta.caps
    # the batched encoder on the card writes the sequential encoder's file
    batched = {}

    def batched_equal(name: str, ref_seq, token_target: int, read_set, seq_file) -> None:
        b0 = time.perf_counter()
        enc = SageEncoder(ref_seq, token_target=token_target, device=dev)
        diff = enc.encode(read_set).diff(seq_file)
        assert not diff, f"{name}: the batched encoder's SageFile differs from the sequential one in {diff}"
        batched[name] = {"seconds": time.perf_counter() - b0, **{k: enc.stats[k] for k in (
            "n_batch_mapped", "n_fallback", "n_escaped", "verify_rounds")}}

    batched_equal("illumina", ref_ill, ill["token_target"], rs, src)
    big = tile_sage_file(src, TILES)
    t0 = time.perf_counter()
    st_big = write_v2(big, WORK / "illumina.sage2")
    t_write = time.perf_counter() - t0
    small = {}
    ref_small = make_reference(60_000, seed=3)
    for prof, kw in (("ont", dict(depth=2, max_reads=14, seed=11)),
                     ("hifi", dict(depth=1, max_reads=6, seed=11))):
        t0 = time.perf_counter()
        prs = sample_read_set(ref_small, prof, **kw)
        sf = SageEncoder(ref_small, token_target=8192, batched=False).encode(prs)
        write_v2(sf, WORK / f"{prof}.sage2")
        small[prof] = (sf, time.perf_counter() - t0)
        batched_equal(prof, ref_small, 8192, prs, sf)
    emit("data", illumina_src_blocks=src.meta.n_blocks, blocks=big.meta.n_blocks,
         bases=int(big.directory[:, D["n_tokens"]].sum()), caps=dataclasses.asdict(src.meta.caps),
         encode_seconds=t_enc, write_seconds=t_write, container_bytes=st_big["file_nbytes"],
         cap_words=st_big["cap_words"], row_words=sum(v for k, v in block_row_widths(src.meta).items() if k != "cons"),
         small={p: {"blocks": sf.meta.n_blocks, "caps": dataclasses.asdict(sf.meta.caps), "seconds": s}
                for p, (sf, s) in small.items()},
         batched_equals_sequential=batched)

    # ---- kernels: kernel vs plain on the card, main-path shapes ------------
    rdr = SageContainerV2.open(WORK / "illumina.sage2")
    widths = tuple((s, int(dict(rdr.layout.widths)[s])) for s in STREAMS)
    dicts = torch.as_tensor(np.asarray(rdr._codec_dicts, np.uint8), device=dev)
    ids = np.arange(BUCKET, dtype=np.int64)
    packed_all = host_to_tensor(rdr.gather_packed(ids), dev)
    caps, classes, fixed_len = src.meta.caps, src.meta.classes, src.meta.fixed_read_len
    rows = ops.unpack(packed_all, dicts, widths)
    arrays = dict(rows)
    arrays["cons"] = host_to_tensor(rdr.gather_consensus_windows(ids), dev)
    arrays["dir"] = host_to_tensor(localize_directory(rdr.directory, ids), dev)
    arrays["valid"] = torch.ones((BUCKET, 1), dtype=torch.int32, device=dev)
    n_tok_real = int(rdr.directory[ids, D["n_tokens"]].sum())
    R, C = caps.segs, caps.tokens
    table = {}
    floor_ms = launch_floor_ms()

    # B1 unpack: one 32-row group upload
    packed = packed_all[:GROUP].contiguous()
    k_out = ops.unpack(packed, dicts, widths)
    p_out = ref.sage_unpack_ref(packed, dicts, widths)
    torch.cuda.synchronize()
    err = max(int((k_out[s].long() - p_out[s].long()).abs().max()) for s, _ in widths)
    row_w = sum(w for _, w in widths)
    b_ms, b_by = bound(packed.numel() * 4 + dicts.numel() + GROUP * row_w * 4, 8 * 4 * GROUP * row_w)
    table["sage_unpack"] = dict(
        route="cuda", source="src/repro_torch/kernels/csrc/sage_unpack.cu",
        replaces="src/repro/kernels/sage_decode.py:270", shape=list(packed.shape), max_abs_err=err,
        match=err == 0, **timings(lambda: ops.unpack(packed, dicts, widths), 200,
                                  lambda: ref.sage_unpack_ref(packed, dicts, widths), 10),
        bound_ms=b_ms, bound_by=b_by, library_ms=None, launch_floor_ms=floor_ms,
        plan={**unpack_plan(GROUP, len(widths)), **ptxas_usage("sage_unpack", "sage_unpack_kernel")})

    # B2 decode: one 256-block bucket
    db = DeviceBlocks(arrays, caps, classes, fixed_len, BUCKET, dev)
    k_dec = ops.sage_decode(db)
    p_dec = ref.sage_decode_ref(db)
    torch.cuda.synchronize()
    keys = ("tokens", "read_pos", "read_rev", "read_start", "read_len", "read_corner")
    err = max(int((k_dec[k].long() - p_dec[k].long()).abs().max()) for k in keys)
    in_bytes = sum(v.numel() * v.element_size() for v in arrays.values())
    out_bytes = BUCKET * C + 5 * BUCKET * R * 4
    b_ms, b_by = bound(in_bytes + out_bytes, 20 * n_tok_real)
    table["sage_decode"] = dict(
        route="cuda", source="src/repro_torch/kernels/csrc/sage_decode.cu",
        replaces="src/repro/kernels/sage_decode.py:51", shape=[BUCKET, C], max_abs_err=err,
        match=err == 0, **timings(lambda: ops.sage_decode(db), 10,
                                  lambda: ref.sage_decode_ref(db), 2),
        bound_ms=b_ms, bound_by=b_by, library_ms=None,
        plan=launch_plan(caps, arrays["cons"].shape[1], BUCKET, "decode", dev))
    del p_dec

    # B3 k-mer and B4 one-hot on the bucket's decoded tokens
    toks = k_dec["tokens"]
    ntok = arrays["dir"][:, D["n_tokens"]].contiguous()
    k_km, p_km = ops.kmer_tokens(toks, KMER_K, ntok), ref.kmer_pack_ref(toks, KMER_K, ntok)
    err = int((k_km.long() - p_km.long()).abs().max())
    b_ms, b_by = bound(toks.numel() + ntok.numel() * 4 + k_km.numel() * 4, 3 * KMER_K * k_km.numel())
    table["kmer_pack"] = dict(
        route="cuda", source="src/repro_torch/kernels/csrc/reformat.cu",
        replaces="src/repro/kernels/reformat.py:56", shape=list(toks.shape), max_abs_err=err,
        match=err == 0, **timings(lambda: ops.kmer_tokens(toks, KMER_K, ntok), 50,
                                  lambda: ref.kmer_pack_ref(toks, KMER_K, ntok), 5),
        bound_ms=b_ms, bound_by=b_by, library_ms=None, launch_floor_ms=floor_ms,
        plan={**kmer_plan(BUCKET, C, KMER_K), **ptxas_usage("reformat", f"kmer_kernelILi{KMER_K}E")})
    k_oh, p_oh = ops.one_hot(toks), ref.one_hot_ref(toks)

    def library_one_hot():
        return torch.nn.functional.one_hot(toks.long(), 5)[..., :4].to(torch.bfloat16)

    err = float((k_oh.float() - p_oh.float()).abs().max())
    assert torch.equal(library_one_hot(), k_oh)
    b_ms, b_by = bound(toks.numel() + k_oh.numel() * 2, 4 * toks.numel())
    table["one_hot"] = dict(
        route="cuda", source="src/repro_torch/kernels/csrc/reformat.cu",
        replaces="src/repro/kernels/reformat.py:103", shape=list(k_oh.shape), max_abs_err=err,
        match=err == 0, **timings(lambda: ops.one_hot(toks), 50, lambda: ref.one_hot_ref(toks), 10),
        bound_ms=b_ms, bound_by=b_by, library_ms=cuda_ms(library_one_hot, 10)[0])
    del k_dec, k_oh, p_oh, k_km, p_km

    # B5 fused gather + decode + format: the bucket's rows are the resident
    # arrays; 208 lanes permuted plus 16 repeats pad to 256 with 32 invalid
    res = DeviceBlocks({k: v for k, v in arrays.items() if k != "valid"}, caps, classes,
                       fixed_len, BUCKET, dev)
    lanes = np.random.default_rng(0).permutation(BUCKET)[: BUCKET * 13 // 16]
    f_ids, f_valid = pad_block_ids(np.concatenate([lanes, lanes[: BUCKET // 16]]))
    sub = gather_block_arrays(res, f_ids, f_valid)
    two = _fill_counts(dict(ops.sage_decode(DeviceBlocks(sub, caps, classes, fixed_len, BUCKET, dev))), sub)
    del sub
    lane_tokens = int(two["n_tokens"].sum())
    row_bytes = sum(v.shape[1] * v.element_size() for v in res.arrays.values())
    G = C // KMER_K
    for fmt in FMTS:
        k_out = ops.sage_fused(res, f_ids, f_valid, fmt, KMER_K)
        p_out = ref.sage_fused_ref(res, f_ids, f_valid, fmt, KMER_K)
        want = dict(two)
        fmt_bytes, fmt_ops = 0, 0
        if fmt == "kmer":
            want["kmer"] = ops.kmer_tokens(two["tokens"], KMER_K, two["n_tokens"])
            fmt_bytes, fmt_ops = BUCKET * G * 4, 3 * KMER_K * BUCKET * G
        elif fmt == "onehot":
            want["onehot"] = ops.one_hot(two["tokens"])
            fmt_bytes, fmt_ops = BUCKET * C * 8, 4 * BUCKET * C
        torch.cuda.synchronize()
        assert sorted(k_out) == sorted(p_out) == sorted(want), (sorted(k_out), sorted(want))
        err = max(max_abs_err(k_out[k], other[k]) for other in (p_out, want) for k in k_out)
        in_bytes = len(np.unique(f_ids)) * row_bytes + f_ids.size * 8
        out_bytes = BUCKET * C + 5 * BUCKET * R * 4 + 2 * BUCKET * 4 + fmt_bytes
        b_ms, b_by = bound(in_bytes + out_bytes, 20 * lane_tokens + fmt_ops)
        table[f"sage_fused_{fmt}"] = dict(
            route="cuda", source="src/repro_torch/kernels/csrc/sage_decode.cu",
            replaces="src/repro/kernels/sage_decode.py:157", shape=[BUCKET, C], max_abs_err=err,
            match=err == 0,
            **timings(lambda fmt=fmt: ops.sage_fused(res, f_ids, f_valid, fmt, KMER_K), 10,
                      lambda fmt=fmt: ref.sage_fused_ref(res, f_ids, f_valid, fmt, KMER_K), 2),
            bound_ms=b_ms, bound_by=b_by, library_ms=None,
            plan=launch_plan(caps, res.arrays["cons"].shape[1], BUCKET, f"fused_{fmt}", dev))
        del k_out, p_out, want
    del two, res, rows, arrays, db, packed_all

    # B6 SSD intra-chunk at mamba2-370m's serving shapes: prefill of 8 prompts
    # of 512 tokens (Q = 128, the tensor-core route) and a decode step (Q = 1,
    # the decode route), timed in bf16 x as the model runs them; as checks f32
    # x, the test draw, large decay in f32 and bf16, chunks of 2, 17 and 127
    # steps and zamba2-2.7b's N = 64 (its train shape and its decode step,
    # each timed in bf16 as the hybrid phase runs it)
    torch.backends.cuda.matmul.allow_tf32 = False  # f32 products in full f32, stated not assumed
    torch.backends.cudnn.allow_tf32 = False
    lm_cfg = get_arch(LM_ARCH)
    sc0 = ServeConfig()
    b6_shapes = {
        "prefill": (LM["prompts"], sc0.max_prompt // lm_cfg.ssm_chunk, lm_cfg.ssm_chunk,
                    lm_cfg.ssm_heads, lm_cfg.ssm_headdim, lm_cfg.ssm_state),
        "decode": (LM["prompts"], 1, 1, lm_cfg.ssm_heads, lm_cfg.ssm_headdim, lm_cfg.ssm_state),
    }
    zcfg = get_arch("zamba2-2.7b")  # the hybrid's Mamba2 layers: N = 64, 80 heads
    b6_shapes["zamba2"] = (2, 2, zcfg.ssm_chunk, zcfg.ssm_heads, zcfg.ssm_headdim, zcfg.ssm_state)
    b6_shapes["zamba2_train"] = (FAMILY_RUN["batch"], FAMILY_RUN["seq"] // zcfg.ssm_chunk, zcfg.ssm_chunk,
                                 zcfg.ssm_heads, zcfg.ssm_headdim, zcfg.ssm_state)  # the hybrid phase's 8 x 512
    b6_shapes["zamba2_decode"] = (FAMILY_RUN["prompts"], 1, 1, zcfg.ssm_heads, zcfg.ssm_headdim,
                                  zcfg.ssm_state)  # the hybrid phase's decode step of 8 prompts
    for q in (1, 2, 17, 64, 120, 127):  # chunk tails of the prefill route; the backward's causal tile edges
        b6_shapes[f"q{q}"] = (2, 3, q, lm_cfg.ssm_heads, lm_cfg.ssm_headdim, lm_cfg.ssm_state)
    b6_checks, b6_rows = {}, {}
    for i, (shp, xdt, decay) in enumerate([
        ("prefill", torch.bfloat16, "serve"), ("decode", torch.bfloat16, "serve"),
        ("prefill", torch.float32, "serve"), ("decode", torch.float32, "serve"),
        ("prefill", torch.float32, "unit"), ("prefill", torch.bfloat16, "unit"),
        ("prefill", torch.float32, "large"), ("prefill", torch.bfloat16, "large"),
        ("q2", torch.float32, "unit"), ("q17", torch.float32, "unit"), ("q127", torch.float32, "large"),
        ("zamba2", torch.float32, "serve"), ("zamba2", torch.bfloat16, "large"),
        ("zamba2_train", torch.bfloat16, "serve"), ("zamba2_train", torch.float32, "large"),
        ("zamba2_decode", torch.bfloat16, "serve"), ("zamba2_decode", torch.float32, "large"),
    ]):
        args = ssd_inputs(b6_shapes[shp], xdt, decay, seed=100 + i, dev=dev)
        name = f"{shp}_{str(xdt)[6:]}_{decay}"
        b6_checks[name] = ssd_check(args, xdt)
        if shp in ("prefill", "decode", "zamba2_train", "zamba2_decode") and decay == "serve" \
                and xdt == torch.bfloat16:  # what the paths launch
            b_ms, b_by = ssd_bound(b6_shapes[shp], 2)
            iters = 200 if shp.endswith("decode") else 50
            row = dict(
                shape=list(b6_shapes[shp]), max_abs_err=max(b6_checks[name][f"{k}_err"] for k in ("y", "state", "total")),
                **timings(lambda args=args: ssd_intra(*args), iters, lambda args=args: ssd_intra_plain(*args), 5),
                bound_ms=b_ms, bound_by=b_by)
            row["bound_share"] = b_ms / row["ms"]
            b6_rows[shp] = row
        del args
    table["ssd_intra"] = dict(
        route="cuda", source="src/repro_torch/kernels/csrc/ssd_chunk.cu",
        replaces="src/repro/kernels/ssd_chunk.py:22", match=all(c["match"] for c in b6_checks.values()),
        **b6_rows["prefill"], library_ms=None, decode=b6_rows["decode"],
        zamba2={**b6_rows["zamba2_train"], "decode": b6_rows["zamba2_decode"]})

    # B6's backward at the train shape (mamba2-370m, 8 x 512 tokens: the
    # prefill shape) with bf16 x, as the train step launches it, timed; as
    # checks f32 x, large decay in f32 and bf16, a 17-step chunk and
    # zamba2-2.7b's N = 64, and the causal tile edges inside a 16 x 8 tile
    # (chunks of 1, 64 and 120 steps)
    bwd_checks, bwd_row = {}, None
    for i, (shp, xdt, decay) in enumerate([
        ("prefill", torch.bfloat16, "serve"), ("prefill", torch.float32, "serve"),
        ("prefill", torch.float32, "large"), ("prefill", torch.bfloat16, "large"),
        ("q17", torch.float32, "unit"), ("zamba2", torch.bfloat16, "serve"),
        ("zamba2_train", torch.bfloat16, "serve"), ("zamba2_train", torch.float32, "large"),
        ("q1", torch.bfloat16, "serve"), ("q64", torch.bfloat16, "unit"), ("q120", torch.float32, "large"),
        ("q120", torch.bfloat16, "large"),
    ]):
        args = ssd_inputs(b6_shapes[shp], xdt, decay, seed=200 + i, dev=dev) + \
            ssd_grads(b6_shapes[shp], xdt, seed=300 + i, dev=dev)
        name = f"{shp}_{str(xdt)[6:]}_{decay}"
        bwd_checks[name] = ssd_bwd_check(args)
        if name == "zamba2_train_bfloat16_serve":  # what the hybrid phase's steps launch
            b_ms, b_by = ssd_bwd_bound(b6_shapes[shp], 2)
            bwd_zamba2 = dict(
                shape=list(b6_shapes[shp]),
                max_abs_err=max(bwd_checks[name][f"{k}_err"] for k in ("dx", "ddt", "da", "dB", "dC")),
                **timings(lambda args=args: ssd_intra_bwd(*args), 20,
                          lambda args=args: ssd_intra_bwd_plain(*args), 3),
                bound_ms=b_ms, bound_by=b_by)
            bwd_zamba2["bound_share"] = b_ms / bwd_zamba2["ms"]
        if bwd_row is None:
            b_ms, b_by = ssd_bwd_bound(b6_shapes[shp], 2)
            bwd_row = dict(
                shape=list(b6_shapes[shp]),
                max_abs_err=max(bwd_checks[name][f"{k}_err"] for k in ("dx", "ddt", "da", "dB", "dC")),
                **timings(lambda args=args: ssd_intra_bwd(*args), 20,
                          lambda args=args: ssd_intra_bwd_plain(*args), 3),
                bound_ms=b_ms, bound_by=b_by)
            bwd_row["bound_share"] = b_ms / bwd_row["ms"]
        del args
    table["ssd_intra_bwd"] = dict(
        route="cuda", source="src/repro_torch/kernels/csrc/ssd_chunk_bwd.cu",
        replaces="no TPU twin: jax.grad of src/repro/models/ssm.py:57 ssd_chunked",
        match=all(c["match"] for c in bwd_checks.values()), **bwd_row, library_ms=None, zamba2=bwd_zamba2,
        plan={**bwd_plan(b6_shapes["prefill"], torch.bfloat16),
              **ptxas_usage("ssd_chunk_bwd", "ssd_bwd_kernelI13__nv_bfloat16")})

    # banded-alignment DP: one full lane chunk of the batched mapper on the
    # Illumina set (1024 lanes, L 150, band 24: width 49), and every card
    # case of tests/dp_cases.py (widths 49, 289 and 641, clipped windows,
    # code 4, a padded bucket); bit for bit against the plain version
    dp_rows, dp_cand, dp_band = dp_lanes(rs.reads, ref_ill, ReadMapper(ref_ill))
    dp_args = [torch.from_numpy(a).to(dev)
               for a in dp_inputs(dp_rows[:DP_LANES], ref_ill, dp_cand[:DP_LANES], dp_band)]
    assert dp_args[0].shape[0] == DP_LANES, dp_args[0].shape
    dp_main = dp_check(dp_args, dp_band)
    dp_cases = {}
    for name in sorted(CARD_DP_CASES):
        arrs, band = scan_inputs(name)
        args = [torch.from_numpy(a).to(dev) for a in arrs]
        plan = align_plan(args[0].shape[0], args[0].shape[1], band, args[1].shape[1])
        dp_cases[name] = {**dp_check(args, band), "route": plan["route"],
                          "ms": cuda_ms(lambda args=args, band=band: ops.banded_align(*args, band=band), 5)[0]}
        del args
    B_, L_, W_ = dp_main["shape"]
    wmax = dp_args[1].shape[1]
    b_ms, b_by = bound(B_ * L_ * W_ + B_ * W_ * 4 + B_ * L_ * 4 + B_ * wmax * 4 + 2 * B_ * 4,
                       DP_OPS_PER_CELL * B_ * L_ * W_)
    dp_plan = align_plan(B_, L_, dp_band, wmax)
    dp_err = max([dp_main["max_abs_err"]] + [c["max_abs_err"] for c in dp_cases.values()])
    kname = f"align_scan_kernelILi{dp_plan['cells_per_thread']}ELb{int(dp_plan['route'] == 'ring')}E"
    table["align_scan"] = dict(
        route="cuda", source="src/repro_torch/kernels/csrc/banded_align.cu",
        replaces="src/repro/kernels/banded_align.py:39", shape=dp_main["shape"], max_abs_err=dp_err,
        match=dp_err == 0, **timings(lambda: ops.banded_align(*dp_args, band=dp_band), 100,
                                     lambda: ref.banded_align_ref(*dp_args, band=dp_band), 2),
        bound_ms=b_ms, bound_by=b_by, library_ms=None, cases=dp_cases,
        bound_rate={"int32_ops_per_s": int32_ops_per_s(), "ops_per_cell": DP_OPS_PER_CELL},
        plan={**dp_plan, **ptxas_usage("banded_align", kname)})
    table["align_scan"]["bound_share"] = b_ms / table["align_scan"]["ms"]
    del dp_args, dp_rows
    emit("kernels", int32_ops_per_s=int32_ops_per_s(), tolerance={"B1-B5, align_scan": "bit-identical (max_abs_err 0)",
                               "B6": {**B6_TOL, "rule": "(rtol, atol); matmul and cuDNN TF32 off"},
                               "B6 backward": {**B6_BWD_TOL, "rule": "(rtol, atol as a share of max|plain|)"}},
         ssd_bwd=table["ssd_intra_bwd"], ssd_bwd_checks=bwd_checks,
         b6_ops_per_s=B6_OPS_PER_S, launch_floor_ms=floor_ms,
         ssd_prefill=b6_rows["prefill"],
         match={k: v["match"] for k, v in table.items()},
         call_ms={k: v["call_ms"] for k, v in table.items()},
         shapes={k: v["shape"] for k, v in table.items()}, ssd_checks=b6_checks,
         ssd_decode=b6_rows["decode"], ssd_zamba2=b6_rows["zamba2_train"],
         ssd_zamba2_decode=b6_rows["zamba2_decode"], align_scan_cases=dp_cases)
    bad = [k for k, v in table.items() if not v["match"]]
    assert not bad, f"kernels disagree with their plain versions: {bad}"

    # ---- main path: SAGe_Read + SAGe_ISP through SageStore on the card -----
    oracles = {"illumina": Oracle(src)}
    oracles.update({p: Oracle(sf) for p, (sf, _s) in small.items()})
    torch.cuda.synchronize()
    torch.cuda.reset_peak_memory_stats()
    peaks = {}  # peak device bytes of each step of the main phase

    def step_peak(name: str) -> None:
        peaks[name] = torch.cuda.max_memory_allocated()
        torch.cuda.reset_peak_memory_stats()

    store = SageStore(max_prepared=16, group_blocks=GROUP)
    for name in ("illumina", "ont", "hifi"):
        store.register(name, str(WORK / f"{name}.sage2"))
    sess = store.session()
    checked = 0
    reset_trace_counts()
    t0 = time.perf_counter()
    read_lo = 7 * GROUP  # a range that starts mid-container
    read_stats = {}
    for fmt in ("2bit", "kmer", "onehot"):
        rng = (read_lo, read_lo + BUCKET)
        out = sess.read("illumina", rng, fmt, kmer_k=KMER_K)  # cold: uploads + unpacks its groups
        torch.cuda.synchronize()
        checked += oracles["illumina"].check(out, out["block_ids"], f"read {fmt}")
        check_format(out, fmt)
        bases = int(out["n_tokens"].sum())
        w0 = time.perf_counter()
        for _ in range(3):
            out = sess.read("illumina", rng, fmt, kmer_k=KMER_K)
        torch.cuda.synchronize()
        read_stats[fmt] = {"blocks": BUCKET, "warm_bases_per_s": 3 * bases / (time.perf_counter() - w0)}
    step_peak("two_step_reads")
    # SAGe_ISP: a 4096-block kmer stream, dispatch depth 2
    n_stream, per_fetch = N_STREAM, PER_FETCH
    stream_start = big.meta.n_blocks - n_stream - 3 * GROUP  # away from the reads' groups
    s0 = time.perf_counter()
    batches = list(sess.read_stream(
        "illumina", mode="dispatch", dispatch=2, blocks_per_fetch=per_fetch, fmt="kmer",
        kmer_k=KMER_K, start_block=stream_start, max_fetches=n_stream // per_fetch,
    ))
    torch.cuda.synchronize()
    stream_s = time.perf_counter() - s0
    stream_bases = sum(int(b.data["n_tokens"].sum()) for b in batches)
    assert sum(len(b.block_ids) for b in batches) == n_stream
    for b in batches:
        checked += oracles["illumina"].check(b.data, b.block_ids, "stream")
        check_format(b.data, "kmer")
    step_peak("dispatch_stream")
    small_checked = {}
    for prof in ("ont", "hifi"):
        for fmt in ("2bit", "kmer", "onehot"):
            out = sess.read(prof, None, fmt, kmer_k=KMER_K)
            torch.cuda.synchronize()
            small_checked[prof] = oracles[prof].check(out, out["block_ids"], f"{prof} {fmt}")
            check_format(out, fmt)
            checked += small_checked[prof]

    step_peak("ont_hifi_reads")
    # ---- fused session: B5 reads, a pipelined stream, the token pipeline ----
    sess_f = store.session(fused=True)
    fused_launches = dict.fromkeys(FMTS, 0)
    two_step = ("launch:sage_decode", "launch:kmer_pack", "launch:one_hot")

    def fused_run(fmt, fn):
        """Run ``fn`` and return its result with the counts it moved; its
        B5 launches count toward ``fmt``, and it launches no B2 / B3 / B4."""
        before = trace_counts()
        result = fn()
        diff = {k: v - before.get(k, 0) for k, v in trace_counts().items() if v != before.get(k, 0)}
        fused_launches[fmt] += diff.get("launch:sage_fused", 0)
        assert not any(diff.get(k) for k in two_step), f"a fused {fmt} run launched {diff}"
        return result, diff

    fused_reads = {}
    rng = (FUSED_READ, FUSED_READ + BUCKET)
    for fmt in FMTS:
        out, diff = fused_run(fmt, lambda: sess_f.read("illumina", rng, fmt, kmer_k=KMER_K))
        torch.cuda.synchronize()
        assert diff.get("launch:sage_fused") == 1, f"fused {fmt} read: {diff}"
        checked += oracles["illumina"].check(out, out["block_ids"], f"fused read {fmt}")
        check_format(out, fmt)
        bases = int(out["n_tokens"].sum())
        w0 = time.perf_counter()
        for _ in range(3):
            out, _d = fused_run(fmt, lambda: sess_f.read("illumina", rng, fmt, kmer_k=KMER_K))
        torch.cuda.synchronize()
        fused_reads[fmt] = {"blocks": BUCKET, "cold_read_counts": diff,
                            "warm_bases_per_s": 3 * bases / (time.perf_counter() - w0)}

    def pipelined(start: int, n_blocks: int):
        with sess_f.read_stream(
            "illumina", mode="pipelined", dispatch=2, readahead=2, blocks_per_fetch=per_fetch,
            fmt="kmer", kmer_k=KMER_K, start_block=start, max_fetches=n_blocks // per_fetch,
        ) as st:
            got = list(st)
        return got, st.stats.to_dict()

    step_peak("fused_reads")
    p0 = time.perf_counter()
    (pbatches, pstats), _d = fused_run("kmer", lambda: pipelined(PIPE_START, N_STREAM))
    torch.cuda.synchronize()
    pipe_s = time.perf_counter() - p0
    assert sum(len(b.block_ids) for b in pbatches) == N_STREAM
    pipe_bases = sum(int(b.data["n_tokens"].sum()) for b in pbatches)
    for b in pbatches:
        checked += oracles["illumina"].check(b.data, b.block_ids, "pipelined stream")
        check_format(b.data, "kmer")
    del pbatches

    tp = TOKENS
    need = tp["batch"] * (tp["seq_len"] + 1)

    def token_pipeline():
        def make():
            return SageTokenPipeline("illumina", vocab_size=kmer_vocab_size(KMER_K), batch=tp["batch"],
                                     seq_len=tp["seq_len"], store=store, stream_mode="pipelined")
        pl = make()
        assert pl.k == KMER_K
        it, got = pl.batches(), []
        for i in range(tp["n_batches"]):
            got.append(next(it))
            if i + 1 == tp["restore_after"]:
                state = pl.state()
        transfers = dict(pl.transfer_stats)
        pl.close()
        pl2 = make()
        pl2.restore(state)
        it2 = pl2.batches()
        again = [next(it2) for _ in range(tp["n_batches"] - tp["restore_after"])]
        pl2.close()
        return got, again, transfers, state

    step_peak("pipelined_stream")
    t_tok = time.perf_counter()
    (tbatches, again, transfers, state), _d = fused_run("kmer", token_pipeline)
    t_tok = time.perf_counter() - t_tok
    kpb = rdr.directory[:, D["n_tokens"]] // KMER_K
    n_tok_blocks = int(np.searchsorted(np.cumsum(kpb), tp["n_batches"] * need)) + 1
    flat = oracles["illumina"].kmer_stream(np.arange(n_tok_blocks), KMER_K)
    for i, b in enumerate(tbatches):
        want = flat[i * need:(i + 1) * need].reshape(tp["batch"], tp["seq_len"] + 1)
        assert np.array_equal(b["tokens"], want[:, :-1]) and np.array_equal(b["labels"], want[:, 1:]), \
            f"token pipeline batch {i} disagrees with refdec's k-mer stream"
    for j, b in enumerate(again):
        ref_b = tbatches[tp["restore_after"] + j]
        assert all(np.array_equal(b[k], ref_b[k]) for k in ("tokens", "labels")), f"restored batch {j}"
    assert transfers["host_transfers"] == tp["n_batches"], transfers
    assert state["cursor"]["consumed"] == tp["restore_after"] * need, state

    counts = trace_counts()
    main_s = time.perf_counter() - t0
    step_peak("token_pipeline")
    peak = max(peaks.values())
    launches = {k: counts.get(f"launch:{k}", 0) for k in table
                if not k.startswith("sage_fused_") and k not in ("ssd_intra", "ssd_intra_bwd", "align_scan")}
    launches.update({f"sage_fused_{f}": n for f, n in fused_launches.items()})
    assert sum(fused_launches.values()) == counts.get("launch:sage_fused", 0), counts
    plain = {k: v for k, v in counts.items() if k.startswith("plain:")}
    emit("main", reads=read_stats, stream={"blocks": n_stream, "blocks_per_fetch": per_fetch,
                                             "bases": stream_bases, "seconds": stream_s,
                                             "bases_per_s": stream_bases / stream_s},
         small_blocks_checked=small_checked,
         fused_reads=fused_reads,
         pipelined_stream={"blocks": N_STREAM, "blocks_per_fetch": per_fetch, "dispatch": 2,
                           "readahead": 2, "bases": pipe_bases, "seconds": pipe_s,
                           "bases_per_s": pipe_bases / pipe_s, "stats": pstats},
         token_pipeline={"batches": len(tbatches), "restored_batches": len(again),
                         "blocks": n_tok_blocks, "seconds": t_tok, "transfer_stats": transfers},
         blocks_checked_against_refdec=checked,
         launches=launches, plain_calls=plain, group_uploads=store.io_stats["group_uploads"],
         peak_device_bytes=peak, peak_device_bytes_by_step=peaks, seconds=main_s)
    assert not plain, f"the main path ran plain versions on the card: {plain}"
    idle = [k for k, n in launches.items() if n == 0]
    assert not idle, f"main path never launched: {idle}"
    # ---- where the time goes: device busy share of a warm read and a cold stream
    def warm_read(_i):  # WARM_READS reads of one resident range
        for _ in range(WARM_READS):
            out = sess.read("illumina", (read_lo, read_lo + BUCKET), "kmer", kmer_k=KMER_K)
        return out

    def cold_stream(i):  # each call streams blocks no earlier phase touched
        return list(sess.read_stream(
            "illumina", mode="dispatch", dispatch=2, blocks_per_fetch=per_fetch, fmt="kmer",
            kmer_k=KMER_K, start_block=N_PROFILE * (1 + i), max_fetches=N_PROFILE // per_fetch))

    def warm_fused_read(_i):
        for _ in range(WARM_READS):
            out = sess_f.read("illumina", (FUSED_READ, FUSED_READ + BUCKET), "kmer", kmer_k=KMER_K)
        return out

    pipe_stats = {}

    def cold_pipelined(i):  # a fused session's pipelined stream, on blocks no earlier phase touched
        got, pipe_stats[i] = pipelined(PIPE_PROFILE + N_PROFILE * i, N_PROFILE)
        return got

    warm_read(0)  # the streams evicted the reads' groups from the device LRU
    warm_fused_read(0)
    windows = {"warm_read_kmer": warm_read, "warm_fused_read_kmer": warm_fused_read,
               "cold_stream_kmer": cold_stream, "cold_pipelined_fused_kmer": cold_pipelined}
    prof = {name: profile_window(fn) for name, fn in windows.items()}
    prof["cold_pipelined_fused_kmer"]["stream_stats"] = pipe_stats[0]
    prof["cold_pipelined_fused_kmer"]["stream_stats_profiled"] = pipe_stats[1]
    emit("profile", **prof)

    # ---- encode: batched SAGe_Write at 1 Mbp; isp: the filter and mapper ---
    launches["align_scan"] = encode_phase(dev)
    isp_phase(ref_ill)

    # ---- lm: mamba2-370m at full width serves store-derived prompts --------
    launches["ssd_intra"], engine = lm_phase(dev, lm_cfg)

    # ---- serve: the SageServer frontend; heal: the self-healing store -------
    serve_phase(lm_cfg, engine, oracles["illumina"])
    del engine
    torch.cuda.empty_cache()
    heal_phase(src, oracles["illumina"])

    # ---- train: mamba2-370m at full width trains on SAGe k-mer tokens -----
    launches["ssd_intra_bwd"] = train_phase(dev, lm_cfg, src, oracles["illumina"])

    # ---- dense and hybrid: qwen2-1.5b and zamba2-2.7b served and trained --
    for kind in FAMILY:
        family_phase(dev, kind, src, oracles["illumina"])
    for k, v in table.items():
        v["launches"] = launches[k]
    kernels = [{"name": k, **{f: v[f] for f in (
        "route", "source", "replaces", "launches", "max_abs_err", "ms", "plain_ms",
        "bound_ms", "bound_by", "library_ms")}, **{f: v[f] for f in ("plan", "launch_floor_ms", "bound_share",
                                                                  "decode", "zamba2", "cases", "bound_rate")
                                                       if f in v}}
        for k, v in table.items()]
    shutil.rmtree(WORK)
    emit("done", seconds=time.perf_counter() - t_start)
    print(json.dumps({"kernels": kernels}))
    print(smi())
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": torch.cuda.get_device_name(0), "count": torch.cuda.device_count()}}))


if __name__ == "__main__":
    main()
