"""Atomic, async checkpoints (the port of
``src/repro/checkpoint/checkpoint.py``), in the same on-disk format:

  * one ``.npy`` file a leaf, named by the leaf's ``/``-joined path with
    ``__``, and a JSON manifest (step, extra, tree structure, and per leaf
    its name, file, shape, dtype and the first 16 hex digits of the sha256
    of its bytes)
  * atomic publish: written to ``step_N.tmp/`` and renamed, so a crashed
    writer never corrupts the latest checkpoint
  * async save: the device->host copy is synchronous (a consistent
    snapshot), the file writes run on a background thread, one in flight
  * ``keep_last`` garbage collection

A state is a nested dict (sorted keys give the leaves' order, as JAX's tree
flattening does) whose leaves are numpy arrays or torch tensors. The
trainer saves the JAX package's layout (``convert.train_state_to_reference``),
so a checkpoint written by either package restores in the other.

Elastic restore, as the reference's: leaves are stored whole, so a restart
may use another mesh. Under ``torch.distributed`` every rank calls
``save``: a DTensor leaf is gathered (``full_tensor()``, a collective),
rank 0 writes (blocking) and a barrier follows; ``restore(shardings=...)``
distributes each leaf on the mesh and with the placements it is given.
"""

from __future__ import annotations

import hashlib
import json
import shutil
import threading
from pathlib import Path
from typing import Any, NamedTuple, Optional

import numpy as np
import torch

from repro_torch.core.errors import IntegrityError


class LeafSpec(NamedTuple):
    """Shape and dtype of a leaf, where ``restore`` needs no values."""

    shape: tuple
    dtype: Any


def _flatten(tree, prefix: str = "") -> list[tuple[str, Any]]:
    if isinstance(tree, dict):
        out = []
        for k in sorted(tree):
            out += _flatten(tree[k], f"{prefix}{k}/")
        return out
    if tree is None:
        return []
    return [(prefix[:-1], tree)]


def _unflatten(like, leaves: dict, prefix: str = ""):
    if isinstance(like, dict):
        return {k: _unflatten(v, leaves, f"{prefix}{k}/") for k, v in like.items()}
    if like is None:
        return None
    return leaves[prefix[:-1]]


def _treedef(tree) -> str:
    def render(t):
        if isinstance(t, dict):
            return "{" + ", ".join(f"{k!r}: {render(t[k])}" for k in sorted(t)) + "}"
        return "None" if t is None else "*"

    return f"PyTreeDef({render(tree)})"


def _host(leaf) -> np.ndarray:
    if isinstance(leaf, torch.Tensor):
        from torch.distributed.tensor import DTensor

        if isinstance(leaf, DTensor):
            leaf = leaf.full_tensor()
        return leaf.detach().cpu().numpy()
    return np.asarray(leaf)


def _ranks() -> tuple[int, int]:
    """(this rank, world size) of the default process group; (0, 1) without one."""
    import torch.distributed as dist

    if dist.is_available() and dist.is_initialized():
        return dist.get_rank(), dist.get_world_size()
    return 0, 1


class CheckpointManager:
    def __init__(self, directory, keep_last: int = 3) -> None:
        self.dir = Path(directory)
        self.dir.mkdir(parents=True, exist_ok=True)
        self.keep_last = keep_last
        self._thread: Optional[threading.Thread] = None

    # ----------------------------------------------------------------- save
    def save(self, step: int, state: dict, extra: Optional[dict] = None, block: bool = False) -> None:
        """Snapshot ``state`` at ``step``. The device->host copy is
        synchronous; file writes happen on a background thread. Under a
        process group of several ranks every rank calls it, rank 0 writes
        and returns after the others reach a barrier."""
        self.wait()  # one in-flight save at a time
        leaves = [(n, _host(leaf)) for n, leaf in _flatten(state)]
        rank, world = _ranks()
        treedef = _treedef(state)

        def write():
            tmp = self.dir / f"step_{step}.tmp"
            if tmp.exists():
                shutil.rmtree(tmp)
            tmp.mkdir(parents=True)
            manifest = {"step": step, "extra": extra or {}, "treedef": treedef, "leaves": []}
            for name, arr in leaves:
                fn = name.replace("/", "__") + ".npy"
                np.save(tmp / fn, arr)
                manifest["leaves"].append({
                    "name": name,
                    "file": fn,
                    "shape": list(arr.shape),
                    "dtype": str(arr.dtype),
                    "sha256_16": hashlib.sha256(arr.tobytes()).hexdigest()[:16],
                })
            (tmp / "manifest.json").write_text(json.dumps(manifest))
            final = self.dir / f"step_{step}"
            if final.exists():
                shutil.rmtree(final)
            tmp.rename(final)  # atomic publish
            self._gc()

        if world > 1:
            import torch.distributed as dist

            if rank == 0:
                write()
            dist.barrier()
        elif block:
            write()
        else:
            self._thread = threading.Thread(target=write, daemon=True)
            self._thread.start()

    def wait(self) -> None:
        if self._thread is not None:
            self._thread.join()
            self._thread = None

    def _gc(self) -> None:
        steps = self.steps()
        for s in steps[: -self.keep_last]:
            shutil.rmtree(self.dir / f"step_{s}", ignore_errors=True)

    # -------------------------------------------------------------- restore
    def steps(self) -> list[int]:
        return sorted(
            int(p.name.split("_")[1])
            for p in self.dir.glob("step_*")
            if p.is_dir() and not p.name.endswith(".tmp") and (p / "manifest.json").exists()
        )

    def latest_step(self) -> Optional[int]:
        s = self.steps()
        return s[-1] if s else None

    def restore(self, like: dict, step: Optional[int] = None, shardings: Optional[dict] = None,
                verify: bool = False):
        """Restore into the structure of ``like`` (a nested dict whose leaves
        have ``.shape``: arrays, tensors or :class:`LeafSpec`). Returns (the
        same structure of host numpy arrays, extra, step). ``verify``
        checks every leaf's checksum and raises :class:`IntegrityError` on
        a mismatch. ``shardings``: a matching dict whose leaves are
        ``(DeviceMesh, placements)`` pairs; those leaves come back as
        DTensors distributed so (elastic resharding onto any mesh)."""
        step = step if step is not None else self.latest_step()
        if step is None:
            raise FileNotFoundError(f"no checkpoints in {self.dir}")
        d = self.dir / f"step_{step}"
        manifest = json.loads((d / "manifest.json").read_text())
        by_name = {rec["name"]: rec for rec in manifest["leaves"]}
        out = {}
        for name, leaf in _flatten(like):
            rec = by_name[name]
            arr = np.load(d / rec["file"])
            if verify:
                got = hashlib.sha256(arr.tobytes()).hexdigest()[:16]
                if got != rec["sha256_16"]:
                    raise IntegrityError(f"checksum mismatch for {name} in step_{step}",
                                         path=str(d / rec["file"]), section=name)
            if tuple(arr.shape) != tuple(leaf.shape):
                raise ValueError(f"{name}: checkpoint shape {arr.shape}, expected {tuple(leaf.shape)}")
            out[name] = arr
        if shardings is not None:
            from torch.distributed.tensor import distribute_tensor

            for name, (mesh, places) in _flatten(shardings):
                t = torch.from_numpy(np.ascontiguousarray(out[name])).to(mesh.device_type)
                out[name] = distribute_tensor(t, mesh, list(places))
        return _unflatten(like, out), manifest["extra"], step
