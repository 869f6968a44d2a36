"""JAX-package side of tests/test_torch_distributed.py: ``repro``'s
``make_dp_train_step`` over 2 and 4 forced host devices, and ``repro``'s
parameter shardings on a (data 2, model 2) mesh, written to
``WORKDIR/reference.npz``.

    XLA_FLAGS=--xla_force_host_platform_device_count=8 python tests/dist_reference.py WORKDIR

The forced device count must be set before JAX starts, so this runs in a
process of its own (the recipe of tests/test_distributed.py). The DP cases
start from the states and batches of ``WORKDIR/inputs.npz`` and run in
threads, whose compilations overlap.
"""

from __future__ import annotations

import dataclasses
import functools
import json
import sys
from concurrent.futures import ThreadPoolExecutor
from pathlib import Path

import jax
import jax.numpy as jnp
import numpy as np
from jax.sharding import NamedSharding
from jax.sharding import PartitionSpec as P

from repro.configs import ARCHS
from repro.distributed.dp_step import make_dp_train_step
from repro.distributed.sharding import Rules, _path_str, param_shardings
from repro.launch.mesh import make_mesh
from repro.models import lm as JLM
from repro.training import optimizer as JO
from repro.training import steps as JS

from dist_cases import ADAMW, DP_ARCHS, DP_COMPRESS, DP_LAYERS, DP_STEPS, ZERO_ARCHS, nest


def flat(tree, prefix: str = "") -> dict:
    out = {}
    for path, leaf in jax.tree_util.tree_flatten_with_path(tree)[0]:
        out[prefix + "/".join(str(getattr(p, "key", getattr(p, "idx", p))) for p in path)] = np.asarray(leaf)
    return out


def dp_case(arch: str, compress: str, n: int, inputs: dict) -> dict:
    cfg = dataclasses.replace(ARCHS[arch].reduced(), n_layers=DP_LAYERS)
    jo = JS.TrainOptions(chunk=32, adamw=JO.AdamWConfig(**ADAMW), grad_compress=compress)
    start = nest(inputs, f"dp/{arch}/")
    mesh = make_mesh((n,), ("data",))
    # placed as the step's outputs are (replicated), so step 2 reuses step 1's compile
    rep, rows = NamedSharding(mesh, P()), NamedSharding(mesh, P("data"))
    params = jax.tree.map(lambda a: jax.device_put(a, rep), start["params"])
    opt = jax.tree.map(lambda a: jax.device_put(a, rep), start["opt"])
    if compress != "int16_ef":
        opt.pop("ef")
    step = jax.jit(make_dp_train_step(cfg, jo, mesh, ("data",), compress=compress))
    out = {}
    for i in range(DP_STEPS):
        batch = {k: jax.device_put(inputs[f"dp_batch/{i}/{k}"], rows) for k in ("tokens", "labels")}
        params, opt, m = step(params, opt, batch)
        for k, v in m.items():
            out[f"metric/{i}/{k}"] = np.asarray(float(v))
    out.update(flat({"params": params, "opt": opt}, "state/"))
    return {f"dp/{arch}/{compress}/{n}/{k}": v for k, v in out.items()}


def shardings() -> dict:
    """Each configuration's parameter paths with their shapes and specs."""
    rules = Rules(make_mesh((2, 2), ("data", "model")), data_axes=("data",))
    out = {}
    for arch, cfg in ARCHS.items():
        shapes = jax.eval_shape(lambda k, cfg=cfg.reduced(): JLM.init_params(k, cfg), jax.random.PRNGKey(0))
        sh = param_shardings(shapes, rules)
        out[arch] = {_path_str(p): [list(leaf.shape), [list(a) if isinstance(a, tuple) else a for a in s.spec]]
                     for (p, leaf), s in zip(jax.tree_util.tree_flatten_with_path(shapes)[0], jax.tree.leaves(sh))}
    return out


def zero1() -> dict:
    """``repro``'s ZeRO-1 moment specs (``launch/specs._zero1_sharding``) on
    a (data 2, model 2) mesh for full-size ZERO_ARCHS: for each leaf its
    shape, and the spec of one layer's slice of it (the stacked leaf's
    leading layer axis cut off, as the port's parameters are), from the
    slice of the leaf's parameter spec."""
    from repro.launch.specs import _zero1_sharding

    rules = Rules(make_mesh((2, 2), ("data", "model")), data_axes=("data",))
    out = {}
    for arch in ZERO_ARCHS:
        shapes = jax.eval_shape(lambda k, cfg=ARCHS[arch]: JLM.init_params(k, cfg), jax.random.PRNGKey(0))
        sh = param_shardings(shapes, rules)
        out[arch] = {}
        for (path, leaf), s in zip(jax.tree_util.tree_flatten_with_path(shapes)[0], jax.tree.leaves(sh)):
            name = _path_str(path)
            lead = 1 if name.split("/")[0] in ("layers", "enc_layers", "dec_layers") else 0
            one = jax.ShapeDtypeStruct(leaf.shape[lead:], leaf.dtype)
            z = _zero1_sharding(one, NamedSharding(rules.mesh, P(*list(s.spec)[lead:])), rules)
            out[arch][name] = [list(leaf.shape), [list(a) if isinstance(a, tuple) else a for a in z.spec]]
    return out


def main(workdir: Path) -> None:
    assert len(jax.devices()) >= 4, jax.devices()
    inputs = dict(np.load(workdir / "inputs.npz"))
    # both packages' forwards in f32 (the train step's default is bf16)
    JLM.forward = functools.partial(JLM.forward, dtype=jnp.float32)
    res = {"shardings": np.asarray(json.dumps(shardings())), "zero1": np.asarray(json.dumps(zero1()))}
    with ThreadPoolExecutor(4) as ex:
        futs = [ex.submit(dp_case, a, c, n, inputs) for a in DP_ARCHS for c in DP_COMPRESS for n in (2, 4)]
        for f in futs:
            res.update(f.result())
    np.savez(workdir / "reference.npz", **res)


if __name__ == "__main__":
    main(Path(sys.argv[1]))
