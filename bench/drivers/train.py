"""Driver ``train``: a closed loop of training steps of the system under test,
fed by its SAGe token pipeline from a container written at set-up.

Set-up writes the traffic's container with the system's ``SageStore.write``
(into the run's TMPDIR), builds the model and AdamW state with the
system's ``init_train_state`` and copies the benchmark's weights in, opens
``SageTokenPipeline`` (fused session, pipelined stream, prefetched) and
runs the first ``checked_steps`` steps through the window's own call and
feed: they warm every shape, and the plain reference follows them. The
window then runs the same step until ``--seconds`` have passed and ends
with the last step (tokens/s = tokens of all its steps over all its time);
a traced run profiles ``trace_steps`` steps instead.

The check, once the window has closed and the system's state is freed:
every batch handed out is parsed back into the synthesized reads and
rebuilt by the reference's k-mer formatter (``tokens_wrong``, exact); the
reference (``bench/reference/<family>.py``, f32, TF32 off) trains from the
same weights on its own rebuild of the first batches and gives each step's
loss, the first moment after step 1 and the parameters after the last
checked step, which the system's are held against (``readings``).
"""

from __future__ import annotations

import gc
import importlib
import math
import time
from types import SimpleNamespace

import numpy as np
import torch

from bench import roofline, synth, weights
from bench.reference import base, kmers


def arch_config(cfg: dict):
    """The system's ArchConfig of a configuration file's ``arch``."""
    import dataclasses

    from repro_torch.configs.base import ArchConfig

    fields = {f.name for f in dataclasses.fields(ArchConfig)}
    return ArchConfig(**{k: v for k, v in cfg.items() if k in fields})


def reference_module(cfg: dict):
    return importlib.import_module(f"bench.reference.{cfg['family']}")


def draw_weights(cfg: dict, seed: int, device) -> dict:
    """The benchmark's weights of ``cfg`` drawn from ``seed`` on ``device``
    (``bench/weights.py``). A draw gives the same weights each time, so a
    side that needs them again after its steps draws them again rather
    than keep a copy on the card through the steps."""
    return weights.make(reference_module(cfg).param_spec(cfg), seed, device)


def train_options(tr: dict):
    from repro_torch.training.optimizer import AdamWConfig
    from repro_torch.training.steps import TrainOptions

    return TrainOptions(adamw=AdamWConfig(**tr["adamw"]))


def write_container(ctx, name: str):
    """(reads, store, path): the traffic's container written by the
    system's SAGe_Write, against the simulator's reference genome, into a
    v2 file in the run's TMPDIR."""
    from repro_torch.core.store import SageStore

    rec = ctx.traffic["container"]
    ref, rs = synth.reads_for(rec, ctx.seed)
    store = SageStore(device=ctx.device)
    path = ctx.tmp / f"bench_{ctx.workload}.sage2"
    store.write(name, rs, ref, token_target=rec["token_target"], layout="v2", path=path)
    ctx.log("container", reads=len(rs.reads), bases=rs.n_bases, blocks=store.n_blocks(name),
            bytes=path.stat().st_size, write=store.last_write_stats)
    return rs, store, path


def leaf_norms(tensors: dict) -> dict:
    return {k: float(torch.linalg.vector_norm(v.detach().double())) for k, v in tensors.items()}


def change_norms(params: dict, w: dict) -> dict:
    """Each leaf's change from the weights ``w`` it started from."""
    return {k: float(torch.linalg.vector_norm((params[k].detach() - w[k]).double())) for k in w}


def gap(prog: dict, ref: dict, grad_ref: dict) -> tuple[float, str]:
    """The worst leaf's |prog norm - ref norm| over the larger of the
    reference's norm of that leaf and of the median leaf; leaves whose
    reference gradient is under a thousandth of the median leaf's (nought
    to rounding) are left out."""
    med_g = float(np.median(list(grad_ref.values())))
    med = float(np.median([ref[k] for k in ref if grad_ref[k] >= 1e-3 * med_g]))
    worst = (0.0, "")
    for k in ref:
        if grad_ref[k] >= 1e-3 * med_g:
            worst = max(worst, (abs(prog[k] - ref[k]) / max(ref[k], med), k))
    return worst


class Cell:
    """The system under test as the traffic builds it, with what its first
    steps gave. The benchmark's weights are dropped once they are copied
    into the model and drawn again from the seed for the change after the
    checked steps, so no copy of them sits on the card through a step."""

    def __init__(self, ctx) -> None:
        from repro_torch.data.pipeline import SageTokenPipeline
        from repro_torch.kernels import cuda_lib
        from repro_torch.training.steps import init_train_state, make_train_step

        self.ctx = ctx
        cfg, tr = ctx.cfg["arch"], ctx.traffic
        self.arch = arch_config(cfg)
        dev = ctx.device
        if dev != "cpu":
            with ctx.phase("extension_load"):
                cuda_lib.build_all()
        with ctx.phase("container_write"):
            self.rs, self.store, self.path = write_container(ctx, "train")
        with ctx.phase("model_init"):
            opts = train_options(tr)
            self.model, self.opt = init_train_state(torch.Generator(device=dev).manual_seed(ctx.seed),
                                                    self.arch, opts, device=dev)
            weights.load_into(self.model, draw_weights(cfg, ctx.seed, dev))
            self.step_fn = make_train_step(self.arch, opts)
            p = tr["pipeline"]
            self.pipe = SageTokenPipeline("train", self.arch.vocab, tr["batch"], tr["seq"], store=self.store,
                                          blocks_per_fetch=p["blocks_per_fetch"], prefetch=p["prefetch"],
                                          dispatch=p["dispatch"], stream_mode=p["stream_mode"])
            self.feed = self.pipe.prefetched()
        self.batches: list[dict] = []  # every batch handed out, on the host
        self.losses: list = []
        with ctx.phase("warm_up"):  # the checked steps: the window's call and feed
            for i in range(tr["checked_steps"]):
                self.step()
                if i == 0:
                    self.m1 = leaf_norms(self.opt["m"])
            self.change = change_norms(dict(self.model.named_parameters()), draw_weights(cfg, ctx.seed, dev))
            ctx.sync()

    def step(self) -> None:
        ctx = self.ctx
        with ctx.spans("data_wait"):
            b = next(self.feed)
            if "batch_token" in ctx.faults:  # a fault the harness's tests plant: a token altered
                b["tokens"][0, 5] = (b["tokens"][0, 5] + 1) % (4 ** self.pipe.k)
            batch = {k: torch.as_tensor(v).to(ctx.device) for k, v in b.items()}
        self.batches.append(b)
        if "half_batch" in ctx.faults:  # half the rows left out, the mean taken over the rest
            batch = {k: v[: v.shape[0] // 2] for k, v in batch.items()}
        with ctx.spans("train_step"):
            if "frozen_step" in ctx.faults:  # the state comes back unchanged
                from repro_torch.training.steps import _grads

                loss, metrics, _g = _grads(self.model, self.arch, batch, train_options(ctx.traffic))
            else:
                _m, self.opt, metrics = self.step_fn(self.model, self.opt, batch)
        self.losses.append(metrics["loss"].detach())

    def close(self) -> None:
        self.feed.close()
        self.pipe.close()
        t = self.pipe._prefetch_thread
        if t is not None:
            t.join(timeout=30)
        self.path.unlink(missing_ok=True)


def reference_train(cfg: dict, tr: dict, seed: int, device, batches: list, precision: str, rows: int,
                    half: bool = False) -> dict:
    """The plain reference's first steps from the benchmark's weights
    (drawn from ``seed`` on ``device``) on ``batches`` ({tokens, labels}
    host arrays): each step's loss, the first moment's and the gradient's
    leaf norms after step 1 and each leaf's change after the last step.
    The gradient of a step is summed from zero over blocks of ``rows``
    rows, in order, each block's mean loss weighted by its share. ``half``
    takes the loss over the first half of each batch's rows only (a fault).

    It holds four f32 copies of the parameters on the device: the
    parameters, one gradient set (each block's ``backward`` adds into
    ``.grad``), and the two moments. The weights it started from are drawn
    again for the change once the gradients are freed."""
    fwd = reference_module(cfg).forward
    mm = base.matmul(precision)
    params = {k: v.clone().requires_grad_(True) for k, v in draw_weights(cfg, seed, device).items()}
    m = {k: torch.zeros_like(p) for k, p in params.items()}
    v_ = {k: torch.zeros_like(p) for k, p in params.items()}
    losses, m1 = [], None
    with base.exact_f32():
        for s, b in enumerate(batches, start=1):
            tok, lab = (torch.as_tensor(b[k], device=device) for k in ("tokens", "labels"))
            if half:
                tok, lab = tok[: tok.shape[0] // 2], lab[: lab.shape[0] // 2]
            B = tok.shape[0]
            for p in params.values():
                p.grad = torch.zeros_like(p)
            total = 0.0
            for r0 in range(0, B, rows):
                part = slice(r0, min(r0 + rows, B))
                loss = base.xent(fwd(params, cfg, tok[part], mm), lab[part]) * ((part.stop - r0) / B)
                loss.backward()
                total += float(loss.detach())
                del loss
            grads = {k: p.grad for k, p in params.items()}
            base.adamw_step(tr["adamw"], params, grads, m, v_, s)
            losses.append(total)
            if s == 1:
                m1 = leaf_norms(m)
                g1 = leaf_norms(grads)
            del grads
    for p in params.values():
        p.grad = None
    change = change_norms(params, draw_weights(cfg, seed, device))
    return {"losses": losses, "m1": m1, "g1": g1, "change": change}


def readings(prog: dict, ref: dict) -> dict:
    """The compared numbers of a run against the reference's, and (keys
    that start with ``_``) what is logged beside them: the worst leaves, and
    the steps' loss gap, which is not compared (no control or fault reads
    three or ten times the system's: PERF.md)."""
    grad_gap, grad_leaf = gap(prog["m1"], ref["m1"], ref["g1"])
    change_gap, change_leaf = gap(prog["change"], ref["change"], ref["g1"])
    loss_gap = max(abs(a - b) / abs(b) for a, b in zip(prog["losses"], ref["losses"]))
    med_g = float(np.median(list(ref["g1"].values())))
    skipped = [k for k, g in ref["g1"].items() if g < 1e-3 * med_g]
    return {"grad_gap": grad_gap, "change_gap": change_gap,
            "_leaves": {"grad": grad_leaf, "change": change_leaf, "left_out": skipped}, "_loss_gap": loss_gap}


def token_check(batches: list, rs, k: int) -> tuple[int, list]:
    """(tokens that differ from the reference's rebuild, the rebuilt
    batches): the batches back to back are parsed into the synthesized
    reads, and the reads as parsed are formatted again by the reference."""
    B, S1 = batches[0]["tokens"].shape[0], batches[0]["tokens"].shape[1] + 1
    rows = [np.concatenate([b["tokens"], b["labels"][:, -1:]], axis=1) for b in batches]
    wrong = sum(int((b["labels"][:, :-1] != b["tokens"][:, 1:]).sum()) for b in batches)
    flat = np.concatenate([r.reshape(-1) for r in rows]).astype(np.int64)
    index = kmers.ReadIndex(rs.reads, k)
    try:
        parsed = kmers.parse_stream(flat, index)
    except ValueError:  # a token that is no k-mer
        return wrong + flat.size, []
    if parsed["bad_at"] is not None:
        return wrong + flat.size - parsed["bad_at"] // k, []
    bases = np.concatenate([index.reads[i][:n] for i, n in parsed["taken"]])
    rebuilt = kmers.kmer_ids(bases, k)
    wrong += int((rebuilt != flat).sum())
    if wrong:
        return wrong, []
    per = B * S1
    out = []
    for i in range(len(batches)):
        chunk = rebuilt[i * per:(i + 1) * per].reshape(B, S1)
        out.append({"tokens": chunk[:, :-1], "labels": chunk[:, 1:]})
    return wrong, out


def check(ctx, prog: dict, batches: list, rs, k: int) -> dict:
    """The compared numbers of a run whose first steps gave ``prog``; the
    ``reference`` line logs the device's peak bytes over the check."""
    tr, cfg = ctx.traffic, ctx.cfg["arch"]
    t_check = time.perf_counter()
    on_card = ctx.device != "cpu"
    if on_card:
        torch.cuda.reset_peak_memory_stats()
    wrong, rebuilt = token_check(batches, rs, k)
    got = {"tokens_wrong": float(wrong)}
    if rebuilt:
        ref = reference_train(cfg, tr, ctx.seed, ctx.device, rebuilt[: tr["checked_steps"]], "f32",
                              tr["reference_rows"])
        r = readings(prog, ref)
        ctx.log("reference", losses=ref["losses"], program_losses=prog["losses"], leaves=r.pop("_leaves"),
                loss_gap=r.pop("_loss_gap"), seconds=time.perf_counter() - t_check,
                memory_peak_bytes=torch.cuda.max_memory_allocated() if on_card else 0)
        got.update(r)
    return got


def window_record(cfg: dict, tr: dict, spans, t0: float) -> SimpleNamespace:
    """What the per-layer readers read beside the traced window: the
    configuration, the traffic, the harness's spans, the window's start,
    a step's model FLOPs (found by family) and B6's launch shape, None
    where the configuration has no SSM layers."""
    B, S = tr["batch"], tr["seq"]
    return SimpleNamespace(cfg=cfg, traffic=tr, spans=spans, t_window=t0,
                           ssd_shape=roofline.ssd_shape(cfg, B, S) if cfg.get("ssm_state", 0) > 0 else None,
                           step_flops=roofline.train_step_flops(cfg, B, S))


def run(ctx) -> dict:
    tr, cfg = ctx.traffic, ctx.cfg["arch"]
    cell = Cell(ctx)
    B, S = tr["batch"], tr["seq"]
    spans = ctx.spans
    ctx.sync()
    t0 = time.perf_counter()
    ctx.phases["setup_s"] = t0 - ctx.t_start
    rec = window_record(cfg, tr, spans, t0)
    if ctx.trace:
        from bench.trace import Window

        spans.profiling = True
        with Window(ctx.device, ("data_wait", "train_step")) as win:
            for _ in range(tr["trace_steps"]):
                cell.step()
        spans.profiling = False
        rec.window, rec.steps = win, tr["trace_steps"]
        elapsed = win.window_s
    else:
        n = 0
        while True:
            cell.step()
            n += 1
            if time.perf_counter() - t0 >= ctx.seconds:
                break
        ctx.sync()
        elapsed = time.perf_counter() - t0
        rec.steps = n
    n_window = rec.steps
    losses = [float(x) for x in cell.losses]
    peak = torch.cuda.max_memory_allocated() if ctx.device != "cpu" else 0
    failed = sum(not math.isfinite(x) for x in losses[tr["checked_steps"]:])
    ctx.log("window", steps=n_window, seconds=elapsed, tokens=n_window * B * S, memory_peak_bytes=peak,
            losses=losses, io_stats=cell.store.io_stats, transfer_stats=cell.pipe.transfer_stats,
            data_wait_ms=spans.mean_ms("data_wait", t0), step_ms=spans.mean_ms("train_step", t0))
    prog = {"losses": losses[: tr["checked_steps"]], "m1": cell.m1, "change": cell.change}
    batches, rs, k = cell.batches, cell.rs, cell.pipe.k
    cell.close()
    del cell
    gc.collect()
    if ctx.device != "cpu":
        torch.cuda.empty_cache()

    got = check(ctx, prog, batches, rs, k)
    e2e = {"train_tokens_per_s": n_window * B * S / elapsed, "setup_s": ctx.phases["setup_s"]}
    return {"e2e": e2e, "rec": rec, "readings": got, "attempted": n_window, "failed": failed,
            "memory_peak_bytes": peak}
