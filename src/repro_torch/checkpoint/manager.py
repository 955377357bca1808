"""Fault-tolerant checkpointing: async, atomic, restorable by either
package (`repro/checkpoint/manager.py`).

  - *atomic*: writes go to step_XXXXXXXX.tmp/, then os.replace() to
    step_XXXXXXXX/; a crash mid-write never corrupts the latest valid
    checkpoint;
  - *async*: the device-to-host copy happens on the caller's thread (the
    caller may then update its tensors in place), serialization on a
    background thread; `wait()` joins before the next save or restore;
  - *the reference's format*: `arrays.npz` with one array a0..aN per leaf
    and `manifest.json` with the step and each leaf's name, dtype and
    shape, leaves in jax's flatten order (dict keys sorted, a NamedTuple's
    fields in order, named `.field`); bfloat16 leaves are stored as their
    uint16 bits. A checkpoint of either package restores in the other;
  - *retention*: keep_last N checkpoints, older ones garbage-collected;
  - *preemption*: PreemptionHandler turns SIGTERM into save-and-exit;
  - *elastic*: a sharded tree (each process's blocks, with its placements
    given as `shardings`) is saved as the whole arrays: the blocks are
    gathered a slab at a time and the process of rank 0 streams them into
    the same archive. `restore(...,
    shardings=)` cuts each whole array to this process's block on any
    mesh shape, as the reference places it on any mesh.
"""
from __future__ import annotations

import json
import os
import shutil
import signal
import threading
from typing import Any, Callable, List, Optional, Tuple

import numpy as np
import torch

PyTree = Any


def flatten_with_paths(tree: PyTree, prefix: Tuple[str, ...] = ()
                       ) -> List[Tuple[str, Any]]:
    """(name, leaf) pairs in jax's flatten order, names as the reference
    writes them ("opt/.m/blocks/wq")."""
    if isinstance(tree, dict):
        return [x for k in sorted(tree)
                for x in flatten_with_paths(tree[k], prefix + (str(k),))]
    if isinstance(tree, tuple) and hasattr(tree, "_fields"):
        return [x for f in tree._fields
                for x in flatten_with_paths(getattr(tree, f),
                                            prefix + ("." + f,))]
    if isinstance(tree, (list, tuple)):
        return [x for i, v in enumerate(tree)
                for x in flatten_with_paths(v, prefix + (str(i),))]
    if tree is None:
        return []
    return [("/".join(prefix), tree)]


def unflatten_like(tree_like: PyTree, leaves) -> PyTree:
    """`tree_like`'s structure with its leaves taken in order from the
    iterator `leaves`."""
    if isinstance(tree_like, dict):
        out = {k: unflatten_like(tree_like[k], leaves)
               for k in sorted(tree_like)}
        return {k: out[k] for k in tree_like}
    if isinstance(tree_like, tuple) and hasattr(tree_like, "_fields"):
        return type(tree_like)(*(unflatten_like(getattr(tree_like, f), leaves)
                                 for f in tree_like._fields))
    if isinstance(tree_like, (list, tuple)):
        return type(tree_like)(unflatten_like(v, leaves) for v in tree_like)
    if tree_like is None:
        return None
    return next(leaves)


def to_host(leaf) -> Tuple[np.ndarray, str]:
    """A copy of `leaf` on the host as (the array npz stores, its dtype's
    name): bfloat16 as its uint16 bits."""
    if isinstance(leaf, torch.Tensor):
        t = leaf.detach().to("cpu", copy=True)
        if t.dtype == torch.bfloat16:
            return t.view(torch.int16).numpy().view(np.uint16), "bfloat16"
        a = t.numpy()
    else:
        a = np.array(leaf)
    if a.dtype.kind not in "biufc":
        raise TypeError(f"cannot checkpoint a leaf of dtype {a.dtype}")
    return a, str(a.dtype)


def from_host(a: np.ndarray, dtype: str, device) -> torch.Tensor:
    a = np.asarray(a, order="C")              # keeps a 0-d leaf 0-d
    if dtype == "bfloat16":
        t = torch.from_numpy(a.view(np.int16)).view(torch.bfloat16)
    else:
        t = torch.from_numpy(a.view(np.dtype(dtype)))
    return t.to(device)


class CheckpointManager:
    def __init__(self, directory: str, keep_last: int = 3):
        self.dir = directory
        self.keep_last = keep_last
        os.makedirs(directory, exist_ok=True)
        self._thread: Optional[threading.Thread] = None

    # -- save ---------------------------------------------------------------
    def save(self, step: int, tree: PyTree, blocking: bool = False,
             shardings: Optional[PyTree] = None) -> None:
        """shardings: `tree` holds this process's blocks, placed as this
        tree of `NamedSharding`s on a bound mesh. Every process of the
        mesh calls save; the whole leaves are gathered slab by slab and
        the process of rank 0 streams them into the archive, so a sharded
        save returns on every process once it is written (`blocking` is
        moot there)."""
        self.wait()
        if shardings is not None:
            self._save_sharded(step, tree, shardings)
            return
        flat = flatten_with_paths(tree)
        names = [n for n, _ in flat]
        host = [to_host(v) for _, v in flat]

        def _write():
            tmp, final = self._begin(step)
            np.savez(os.path.join(tmp, "arrays.npz"),
                     **{f"a{i}": a for i, (a, _) in enumerate(host)})
            self._finish(tmp, final, step, names, [d for _, d in host],
                         [list(a.shape) for a, _ in host])

        if blocking:
            _write()
        else:
            self._thread = threading.Thread(target=_write, daemon=True)
            self._thread.start()

    def _begin(self, step: int):
        tmp = os.path.join(self.dir, f"step_{step:08d}.tmp")
        os.makedirs(tmp, exist_ok=True)
        return tmp, os.path.join(self.dir, f"step_{step:08d}")

    def _finish(self, tmp, final, step, names, dtypes, shapes) -> None:
        with open(os.path.join(tmp, "manifest.json"), "w") as f:
            json.dump({"step": step, "names": names, "dtypes": dtypes,
                       "shapes": shapes}, f)
        if os.path.exists(final):
            shutil.rmtree(final)
        os.replace(tmp, final)
        self._gc()

    def _save_sharded(self, step: int, tree: PyTree, shardings: PyTree):
        """The archive `np.savez` would write, streamed: each leaf's .npy
        entry is its header, then its whole value gathered one slab of its
        leading axis at a time (a stacked leaf: one layer), so rank 0
        holds one slab on the host, not the tree."""
        import zipfile
        from ..models.params import gather_leaf
        flat = flatten_with_paths(tree)
        sh = [s for _, s in flatten_with_paths(shardings)]
        if len(sh) != len(flat):
            raise ValueError("shardings do not match the tree")
        mesh = sh[0].mesh
        writer = mesh.rank == 0
        dtypes, shapes = [], []
        if writer:
            tmp, final = self._begin(step)
            zf = zipfile.ZipFile(os.path.join(tmp, "arrays.npz"), "w",
                                 zipfile.ZIP_STORED, allowZip64=True)
        try:
            for i, ((_, v), s) in enumerate(zip(flat, sh)):
                spec = tuple(s.spec) + (None,) * (v.ndim - len(s.spec))
                sliced = v.ndim > 0 and spec[0] is None
                slabs = ([(v[j], spec[1:]) for j in range(v.shape[0])]
                         if sliced else [(v, spec)])
                out = None
                for t, sp in slabs:
                    a, name = to_host(gather_leaf(t, sp, mesh))
                    if not writer:
                        continue
                    if out is None:
                        shape = ((v.shape[0],) + a.shape if sliced
                                 else a.shape)
                        dtypes.append(name)
                        shapes.append(list(shape))
                        out = zf.open(f"a{i}.npy", "w", force_zip64=True)
                        np.lib.format.write_array_header_2_0(out, {
                            "descr": np.lib.format.dtype_to_descr(a.dtype),
                            "fortran_order": False, "shape": shape})
                    out.write(np.ascontiguousarray(a).tobytes())
                if out is not None:
                    out.close()
        finally:
            if writer:
                zf.close()
        if writer:
            self._finish(tmp, final, step, [n for n, _ in flat], dtypes,
                         shapes)
        torch.distributed.barrier()

    def wait(self) -> None:
        if self._thread is not None:
            self._thread.join()
            self._thread = None

    def _gc(self) -> None:
        steps = self.all_steps()
        for s in steps[:-self.keep_last]:
            shutil.rmtree(os.path.join(self.dir, f"step_{s:08d}"),
                          ignore_errors=True)

    # -- restore ------------------------------------------------------------
    def all_steps(self):
        out = []
        for n in os.listdir(self.dir):
            if n.startswith("step_") and not n.endswith(".tmp"):
                out.append(int(n.split("_")[1]))
        return sorted(out)

    def latest_step(self) -> Optional[int]:
        steps = self.all_steps()
        return steps[-1] if steps else None

    def restore(self, tree_like: PyTree, step: Optional[int] = None,
                device=None, shardings: Optional[PyTree] = None) -> PyTree:
        """The checkpoint at `step` (the latest by default) in the
        structure of `tree_like`, each leaf in its stored dtype on
        `device`, or where `tree_like`'s leaf lies. shardings: a tree of
        `NamedSharding`s on a bound mesh of any shape; each leaf is then
        this process's block of the stored array (elastic restore)."""
        self.wait()
        step = self.latest_step() if step is None else step
        if step is None:
            raise FileNotFoundError(f"no checkpoints in {self.dir}")
        d = os.path.join(self.dir, f"step_{step:08d}")
        with open(os.path.join(d, "manifest.json")) as f:
            manifest = json.load(f)
        flat = flatten_with_paths(tree_like)
        names = [n for n, _ in flat]
        if names != manifest["names"]:
            raise ValueError(f"checkpoint {d} holds another tree: "
                             f"{manifest['names'][:4]}... vs {names[:4]}...")
        with np.load(os.path.join(d, "arrays.npz")) as z:
            leaves = [from_host(z[f"a{i}"], manifest["dtypes"][i],
                                device if device is not None else like.device)
                      for i, (_, like) in enumerate(flat)]
        if shardings is not None:
            from ..models.params import shard_leaf
            sh = [s for _, s in flatten_with_paths(shardings)]
            if len(sh) != len(leaves):
                raise ValueError("shardings do not match the tree")
            leaves = [shard_leaf(t, s.spec, s.mesh)
                      for t, s in zip(leaves, sh)]
        return unflatten_like(tree_like, iter(leaves))


class PreemptionHandler:
    """SIGTERM -> save once at the next step boundary, then exit."""

    def __init__(self, save_fn: Callable[[], None]):
        self._requested = False
        self._save_fn = save_fn
        for sig in (signal.SIGTERM,):
            try:
                signal.signal(sig, self._handler)
            except ValueError:
                pass  # not on main thread (tests)

    def _handler(self, signum, frame):
        self._requested = True

    @property
    def preempted(self) -> bool:
        return self._requested

    def checkpoint_if_preempted(self) -> bool:
        if self._requested:
            self._save_fn()
            return True
        return False
