"""Rank side of tests/test_torch_distributed.py (imports only the port): each
of WORLD gloo CPU ranks runs every multi-rank case once and saves its
results in ``rank<r>.npz`` under the work directory.

    python tests/dist_cases.py WORKDIR RANK WORLD

The inputs (``inputs.npz``, written by the test with numpy and the JAX
package) are the pipeline's layers, the MoE layer's parameters and input,
and the train states and batches of the DP cases. The process group meets
on a ``FileStore`` in WORKDIR.
"""

from __future__ import annotations

import contextlib
import dataclasses
import functools
import json
import sys
from pathlib import Path

import numpy as np
import torch

DP_ARCHS = ("mamba2-370m", "qwen2-1.5b")
DP_COMPRESS = ("int16_ef", "bf16")
DP_STEPS = 2
DP_LAYERS = 1  # the reduced configurations cut to one layer (keeps the reference's compiles short)
MOE_ARCH = "deepseek-moe-16b"
ADAMW = dict(lr=1e-3, total_steps=8, warmup_steps=2)
RULE_CASES = [  # (data_axes, seq_shard, pure_dp) of Rules on a (data 2, model 2) mesh
    (("data",), False, False), (("data",), True, False), (("data",), False, True),
    (("pod", "data"), True, False), ((), False, False),
]
RULE_NAMES = ("act_btd", "act_heads", "act_ff", "act_btv", "tokens", "kv_cache", "kv_cache_seq",
              "ssm_state", "sage_blocks")
TP_CASES = (("qwen2-1.5b", True), ("qwen2-1.5b", False), ("mamba2-370m", True), ("deepseek-moe-16b", True))  # (arch, seq_shard)
TP_STEPS = 2
TP_BATCH = (4, 64)
TP_PREFILL_LEN = 80  # the prefill's cache slots (64 tokens, zeros after)
ZERO_ARCHS = ("qwen2-1.5b", "mamba2-370m")  # full size, shapes only (fake tensors)


def nest(flat: dict, prefix: str) -> dict:
    """{"a/b/c": x} entries under ``prefix`` as nested dicts."""
    out: dict = {}
    for k, v in flat.items():
        if not k.startswith(prefix):
            continue
        node = out
        parts = k[len(prefix):].split("/")
        for p in parts[:-1]:
            node = node.setdefault(p, {})
        node[parts[-1]] = v
    return out


def part_json(part: tuple) -> list:
    return [list(a) if isinstance(a, tuple) else a for a in part]


def dp_options(compress: str):
    from repro_torch.training import steps as TS
    from repro_torch.training.optimizer import AdamWConfig

    return TS.TrainOptions(chunk=32, adamw=AdamWConfig(**ADAMW), grad_compress=compress)


def dp_run(arch: str, compress: str, mesh, inputs: dict) -> dict:
    """DP_STEPS of ``make_dp_train_step`` (f32 forward) from the JAX
    package's initial state; returns the metrics and the final state in the
    JAX package's layout as {"<key>": array}."""
    from repro_torch.checkpoint.checkpoint import _flatten
    from repro_torch.configs import get_arch
    from repro_torch.convert import train_state_from_reference, train_state_to_reference
    from repro_torch.distributed.dp_step import make_dp_train_step
    from repro_torch.models import lm
    from repro_torch.training.steps import _stacked

    cfg = dataclasses.replace(get_arch(arch).reduced(), n_layers=DP_LAYERS)
    start = nest(inputs, f"dp/{arch}/")
    opt = dict(start["opt"])
    if compress != "int16_ef":
        opt.pop("ef")
    model = lm.init_params(torch.Generator().manual_seed(0), cfg, device="cpu")
    sd, topt = train_state_from_reference(cfg, start["params"], opt)
    model.load_state_dict(sd)
    step = make_dp_train_step(cfg, dp_options(compress), mesh, ("data",), compress=compress)
    out = {}
    orig = lm.forward
    lm.forward = functools.partial(orig, dtype=torch.float32)
    try:
        for i in range(DP_STEPS):
            batch = {k: torch.from_numpy(inputs[f"dp_batch/{i}/{k}"]) for k in ("tokens", "labels")}
            model, topt, m = step(model, topt, batch)
            for k, v in m.items():
                out[f"metric/{i}/{k}"] = np.asarray(float(v))
    finally:
        lm.forward = orig
    out.update({f"state/{k}": np.asarray(v) for k, v in _flatten(train_state_to_reference(cfg, model, topt))})
    if compress == "int16_ef":  # the last step's quantum s, an ef leaf's shape ("quantum/opt/ef/...")
        scale = step.wire["scale"]
        quanta = {**topt, "ef": {k: torch.full_like(v, float(scale[_stacked(k)])) for k, v in topt["ef"].items()}}
        out.update({f"quantum/{k}": np.asarray(v) for k, v in _flatten(train_state_to_reference(cfg, model, quanta))
                    if k.startswith("opt/ef/")})
    out["wire_bytes"] = np.asarray(step.wire["bytes"])
    out["wire_elements"] = np.asarray(step.wire["elements"])
    return out


def tp_run(arch: str, seq_shard: bool, mesh, inputs: dict, start=None, first: int = 0, steps: int = TP_STEPS) -> dict:
    """``steps`` of ``make_train_step`` (f32 forward) of reduced ``arch`` on
    the TP batches from ``first`` on, from the port's seed-0 weights and
    zero AdamW state: with ``mesh`` (data 2, model 2), its parameters as
    DTensors (``distribute_model``) under ``Rules(mesh, seq_shard=)`` and
    the batch entering as "tokens"; with ``mesh`` None, the one-rank step,
    from ``start`` (a state as this returns it, flat in the JAX package's
    layout) where given. Returns the metrics and, after each step, the
    state gathered whole ("state/<i>/<key>")."""
    from torch.distributed.tensor import distribute_tensor

    from repro_torch.configs import get_arch
    from repro_torch.convert import train_state_from_reference
    from repro_torch.distributed.sharding import Rules, distribute_model, use_rules
    from repro_torch.models import lm
    from repro_torch.training import steps as TS
    from repro_torch.training.optimizer import adamw_init
    from train_cases import whole_state

    cfg = get_arch(arch).reduced()
    model = lm.init_params(torch.Generator().manual_seed(0), cfg, device="cpu")
    rules = None if mesh is None else Rules(mesh, seq_shard=seq_shard)
    if rules is not None:
        distribute_model(model, rules)
    opt = adamw_init(dict(model.named_parameters()))
    if start is not None:
        sd, opt = train_state_from_reference(cfg, nest(start, "params/"), nest(start, "opt/"))
        model.load_state_dict(sd)
    step = TS.make_train_step(cfg, dp_options(None))
    out = {}
    orig = lm.forward
    lm.forward = functools.partial(orig, dtype=torch.float32)
    try:
        with use_rules(rules):
            for i in range(first, first + steps):
                batch = {k: torch.from_numpy(inputs[f"tp_batch/{i}/{k}"]) for k in ("tokens", "labels")}
                if rules is not None:
                    batch = {k: distribute_tensor(v, mesh, rules.spec("tokens"), src_data_rank=None)
                             for k, v in batch.items()}
                model, opt, m = step(model, opt, batch)
                for k, v in m.items():
                    out[f"metric/{i}/{k}"] = np.asarray(float(v))
                out.update({f"state/{i}/{k}": v for k, v in whole_state(cfg, model, opt).items()})
    finally:
        lm.forward = orig
    return out


def tp_prefill(mesh, inputs: dict) -> dict:
    """Reduced qwen2-1.5b's f32 prefill of the first TP batch into
    TP_PREFILL_LEN slots, under ``Rules(mesh, seq_shard=True)`` with DTensor
    parameters (``mesh`` None: one rank): the last position's logits and
    the cache's k and v, gathered whole."""
    from torch.distributed.tensor import distribute_tensor

    from repro_torch.configs import get_arch
    from repro_torch.distributed.sharding import Rules, distribute_model, is_dtensor, use_rules
    from repro_torch.models import lm

    cfg = get_arch("qwen2-1.5b").reduced()
    model = lm.init_params(torch.Generator().manual_seed(0), cfg, device="cpu")
    tokens = torch.from_numpy(inputs["tp_batch/0/tokens"])
    rules = None if mesh is None else Rules(mesh, seq_shard=True)
    if rules is not None:
        distribute_model(model, rules)
        tokens = distribute_tensor(tokens, mesh, rules.spec("tokens"), src_data_rank=None)
    with use_rules(rules):
        logits, cache = lm.prefill(model, cfg, tokens, TP_PREFILL_LEN, chunk=32, dtype=torch.float32)
    whole = {"logits": logits, "k": cache["k"], "v": cache["v"]}
    return {k: np.asarray(v.full_tensor() if is_dtensor(v) else v) for k, v in whole.items()}


@contextlib.contextmanager
def recorded_acts(log: list):
    """Every ``shard_act`` call of the models appends (name, placements of
    its result) to ``log`` (the models' modules' own ``shard_act`` names
    are patched, so nothing else changes)."""
    from repro_torch.distributed.sharding import is_dtensor, shard_act
    from repro_torch.models import layers, lm, ssm

    def rec(x, name):
        y = shard_act(x, name)
        if is_dtensor(y):
            log.append((name, repr(tuple(y.placements))))
        return y

    mods = (layers, lm, ssm)
    for m in mods:
        m.shard_act = rec
    try:
        yield log
    finally:
        for m in mods:
            m.shard_act = shard_act


def main(workdir: Path, rank: int, world: int) -> None:
    import torch.distributed as dist
    from torch.distributed.device_mesh import init_device_mesh
    from torch.distributed.tensor import Shard, distribute_tensor

    torch.set_num_threads(1)
    inputs = dict(np.load(workdir / "inputs.npz"))
    dist.init_process_group("gloo", store=dist.FileStore(str(workdir / "store"), world), rank=rank,
                            world_size=world)
    res: dict = {}
    try:
        pipe = init_device_mesh("cpu", (4,), mesh_dim_names=("pipe",))
        from repro_torch.launch.mesh import make_mesh, make_production_mesh

        dm = make_mesh((2, 2), ("data", "model"), device_type="cpu")
        try:
            make_production_mesh(device_type="cpu")
        except ValueError as e:
            res["production_mesh_error"] = np.asarray(str(e))
        data4 = init_device_mesh("cpu", (4,), mesh_dim_names=("data",))

        # ---- PP: tanh layers, 4 stages, 3 microbatches
        from repro_torch.distributed.pipeline import pipeline_apply

        res["pp"] = pipeline_apply(pipe, "pipe", lambda w, h: torch.tanh(h @ w),
                                   torch.from_numpy(inputs["pp/ws"]), torch.from_numpy(inputs["pp/x"]),
                                   n_microbatch=3).numpy()

        # ---- EP: reduced deepseek-moe-16b on (data 2, model 2); this rank's rows
        from repro_torch.configs import get_arch
        from repro_torch.distributed.sharding import Rules, use_rules
        from repro_torch.models import moe as M

        cfg = get_arch(MOE_ARCH).reduced()
        p = {k: v for k, v in nest({k: torch.from_numpy(v) for k, v in inputs.items()}, "moe/p/").items()}
        x = torch.from_numpy(inputs["moe/x"])
        d = dm.get_local_rank("data")
        rows = x.shape[0] // 2
        with use_rules(Rules(dm, data_axes=("data",))):
            y, aux = M.moe_apply(p, x[d * rows:(d + 1) * rows], cfg)
        res["ep/y"], res["ep/aux"], res["ep/data"] = y.numpy(), np.asarray(float(aux)), np.asarray(d)

        # ---- DP over 2 ranks (the data axis of (data 2, model 2)) and 4
        for arch in DP_ARCHS:
            for compress in DP_COMPRESS:
                for n, mesh in ((2, dm), (4, data4)):
                    for k, v in dp_run(arch, compress, mesh, inputs).items():
                        res[f"dp/{arch}/{compress}/{n}/{k}"] = v

        # ---- elastic restore: saved Shard(0) on 4 ranks, restored onto (2, 2)
        from repro_torch.checkpoint.checkpoint import CheckpointManager, LeafSpec

        model4 = init_device_mesh("cpu", (4,), mesh_dim_names=("model",))
        ab = init_device_mesh("cpu", (2, 2), mesh_dim_names=("a", "b"))
        w = distribute_tensor(torch.arange(64.0).reshape(8, 8), model4, [Shard(0)])
        cm = CheckpointManager(workdir / "ckpt")
        cm.save(1, {"w": w}, block=True)
        got, _extra, step = cm.restore({"w": LeafSpec((8, 8), np.float32)},
                                       shardings={"w": (ab, (Shard(1), Shard(0)))})
        res["elastic/local"] = got["w"].to_local().numpy()
        res["elastic/full"] = got["w"].full_tensor().numpy()
        res["elastic/placements"] = np.asarray(repr(tuple(got["w"].placements)))
        res["elastic/mesh"] = np.asarray(repr(tuple(got["w"].device_mesh.mesh_dim_names)))
        res["elastic/step"] = np.asarray(step)

        # ---- shard_act: a DTensor activation to its logical placements
        from torch.distributed.tensor import Replicate

        from repro_torch.distributed.sharding import shard_act

        act = torch.arange(4 * 6 * 8, dtype=torch.float32).reshape(4, 6, 8)
        rep = distribute_tensor(act, dm, [Replicate(), Replicate()])
        for seq in (False, True):
            with use_rules(Rules(dm, seq_shard=seq)):
                got = shard_act(rep, "act_btd")
                assert shard_act(act, "act_btd") is act and shard_act(rep, "no_such_name") is rep
            res[f"shard_act/{seq}/placements"] = np.asarray(repr(tuple(got.placements)))
            res[f"shard_act/{seq}/local"] = got.to_local().numpy()
            res[f"shard_act/{seq}/full"] = got.full_tensor().numpy()
        assert shard_act(rep, "act_btd") is rep  # no rules installed

        # ---- Rules and parameter placements on (data 2, model 2)
        if rank == 0:
            from repro_torch.configs.registry import ARCHS
            from repro_torch.distributed.sharding import param_shardings, param_spec
            from repro_torch.models import lm

            rules = {}
            for data_axes, seq, pure in RULE_CASES:
                r = Rules(dm, data_axes=data_axes, seq_shard=seq, pure_dp=pure)
                rules[json.dumps([list(data_axes), seq, pure])] = {
                    n: [part_json(r.partition(n)), repr(r.spec(n))] for n in RULE_NAMES}
            params = {}
            r = Rules(dm)
            for arch in ARCHS:
                model = lm.init_params(torch.Generator().manual_seed(0), get_arch(arch).reduced(), device="cpu")
                named = dict(model.named_parameters())
                places = param_shardings(named, r)
                params[arch] = {k: [part_json(param_spec(k, v.ndim, r)), repr(places[k]), list(v.shape)]
                                for k, v in named.items()}
            res["rules"] = np.asarray(json.dumps({"rules": rules, "params": params}))

            # ZeRO-1 moment placements of full-size parameters (no allocation)
            from torch._subclasses.fake_tensor import FakeTensorMode

            from repro_torch.launch.specs import _zero1_sharding

            zero = {}
            with FakeTensorMode():
                for arch in ZERO_ARCHS:
                    named = dict(lm.init_params(torch.Generator(), get_arch(arch), device="cpu").named_parameters())
                    places = param_shardings(named, r)
                    zero[arch] = {k: [list(v.shape), repr(_zero1_sharding(tuple(v.shape), places[k], r))]
                                  for k, v in named.items()}
            res["zero1"] = np.asarray(json.dumps(zero))

        # ---- TP / SP through the LM on (data 2, model 2): train steps, a prefill, the named points
        acts: dict = {}
        for arch, seq in TP_CASES:
            with recorded_acts(acts.setdefault(f"{arch}/{seq}", [])):
                for k, v in tp_run(arch, seq, dm, inputs).items():
                    res[f"tp/{arch}/{seq}/{k}"] = v
        res["tp/acts"] = np.asarray(json.dumps(acts))
        for k, v in tp_prefill(dm, inputs).items():
            res[f"tp_prefill/{k}"] = v
    finally:
        dist.destroy_process_group()
    np.savez(workdir / f"rank{rank}.npz", **res)


if __name__ == "__main__":
    main(Path(sys.argv[1]), int(sys.argv[2]), int(sys.argv[3]))
