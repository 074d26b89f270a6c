"""Checkpointing — on the paper's own transparent file structure.

Checkpoints are written through ``core.fstore`` (zarr-v2 layout) in the
reference's layout (``repro.checkpoint``), so a training state is as
inspectable as the index: every leaf is a raw chunk file + JSON metadata,
readable from any language, and the two packages write the same bytes for
the same tree and read each other's checkpoints.

  ckpt_root/step_00000100/
    .zattrs                      {"step": 100, "skeleton": ...}
    leaf_000000/ ... leaf_N/     one array per tree leaf

Features: atomic publish (write to a tmp dir, rename), an async save
thread, keep_n retention, restore-latest.  Trees are nested
dict/list/tuple with tensors, numpy arrays or scalars at the leaves;
tensors go to host numpy on the calling thread, so an in-place update in
the next step cannot race the write.  ``load_tree`` hands back numpy.
bfloat16 leaves are refused, as the reference's fstore refuses them.
"""
from __future__ import annotations

import os
import shutil
import threading
from pathlib import Path

import numpy as np
import torch

from ..core.fstore import FStore
from ..tree import tree_map

__all__ = ["CheckpointManager", "save_tree", "load_tree"]


def _flatten(tree, path=()):  # -> skeleton, list[(path, leaf)]
    if tree is None:
        return "__none__", []
    if isinstance(tree, dict):
        skel, leaves = {}, []
        for k in sorted(tree):
            s, l = _flatten(tree[k], path + (k,))
            skel[k] = s
            leaves.extend(l)
        return skel, leaves
    if isinstance(tree, (list, tuple)):
        skel, leaves = [], []
        for i, v in enumerate(tree):
            s, l = _flatten(v, path + (str(i),))
            skel.append(s)
            leaves.extend(l)
        return {"__seq__": skel, "__tuple__": isinstance(tree, tuple)}, leaves
    return "__leaf__", [(path, tree)]


def _unflatten(skel, leaves_iter):
    if skel == "__none__":
        return None
    if skel == "__leaf__":
        return next(leaves_iter)
    if isinstance(skel, dict) and "__seq__" in skel:
        seq = [_unflatten(s, leaves_iter) for s in skel["__seq__"]]
        return tuple(seq) if skel["__tuple__"] else seq
    return {k: _unflatten(skel[k], leaves_iter) for k in sorted(skel)}


def to_host(leaf) -> np.ndarray:
    """A leaf as host numpy (a tensor copied, also from the CPU, so that the
    copy outlives in-place updates); a tensor numpy cannot hold raises the
    reference's ``TypeError``."""
    if isinstance(leaf, torch.Tensor):
        if leaf.dtype == torch.bfloat16:
            raise TypeError("unsupported dtype for fstore: bfloat16")
        return leaf.detach().to("cpu", copy=True).numpy()
    return np.asarray(leaf)


def save_tree(path: str, tree, *, attrs: dict | None = None) -> None:
    tmp = Path(str(path) + ".tmp")
    if tmp.exists():
        shutil.rmtree(tmp)
    store = FStore(tmp, create=True)
    skel, leaves = _flatten(tree)
    meta = dict(attrs or {})
    meta["skeleton"] = skel
    meta["n_leaves"] = len(leaves)
    for i, (p, leaf) in enumerate(leaves):
        arr = to_host(leaf)
        store.write_array(f"leaf_{i:06d}", arr, attrs={"path": "/".join(p), "shape": list(arr.shape)})
    store.write_attrs("", meta)
    final = Path(path)
    if final.exists():
        shutil.rmtree(final)
    os.replace(tmp, final)


def load_tree(path: str):
    store = FStore(path)
    meta = store.read_attrs("")
    n = int(meta["n_leaves"])
    leaves = [store.read_array(f"leaf_{i:06d}") for i in range(n)]
    tree = _unflatten(meta["skeleton"], iter(leaves))
    return tree, {k: v for k, v in meta.items() if k not in ("skeleton", "n_leaves")}


class CheckpointManager:
    def __init__(self, root: str, *, keep_n: int = 3, async_save: bool = True):
        self.root = Path(root)
        self.root.mkdir(parents=True, exist_ok=True)
        self.keep_n = keep_n
        self.async_save = async_save
        self._thread: threading.Thread | None = None
        self._error: BaseException | None = None
        self.saves = 0

    def _step_dir(self, step: int) -> Path:
        return self.root / f"step_{step:08d}"

    def steps(self) -> list[int]:
        out = []
        for d in self.root.iterdir():
            if d.name.startswith("step_") and not d.name.endswith(".tmp"):
                out.append(int(d.name[5:]))
        return sorted(out)

    def latest_step(self) -> int | None:
        s = self.steps()
        return s[-1] if s else None

    def wait(self) -> None:
        if self._thread is not None:
            self._thread.join()
            self._thread = None
        if self._error is not None:
            err, self._error = self._error, None
            raise err  # async save failures must not be silent

    def save(self, step: int, tree, *, attrs: dict | None = None) -> None:
        # to host on the calling thread (the step after this one updates the
        # tensors in place), file IO on the background thread
        host_tree = tree_map(to_host, tree)
        a = dict(attrs or {})
        a["step"] = step

        def work():
            try:
                save_tree(str(self._step_dir(step)), host_tree, attrs=a)
                self._gc()
            except BaseException as e:  # surfaced on next wait()
                self._error = e

        self.wait()
        self.saves += 1
        if self.async_save:
            self._thread = threading.Thread(target=work, daemon=True)
            self._thread.start()
        else:
            work()

    def restore(self, step: int | None = None):
        """(the tree as host numpy, its step), or (None, None) when there is
        no checkpoint."""
        self.wait()
        if step is None:
            step = self.latest_step()
        if step is None:
            return None, None
        tree, meta = load_tree(str(self._step_dir(step)))
        return tree, int(meta["step"])

    def _gc(self) -> None:
        steps = self.steps()
        for s in steps[: -self.keep_n] if self.keep_n else []:
            shutil.rmtree(self._step_dir(s), ignore_errors=True)
