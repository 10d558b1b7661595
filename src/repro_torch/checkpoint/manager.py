"""Atomic, async checkpointing of the port's trees (twin of
``repro.checkpoint.manager``), in the reference's layout.

  * **Atomic**: a checkpoint directory ``step_<n>`` appears under its
    final name only after every file in it is written (a tmp dir, then
    ``os.replace``); a crash mid-save never corrupts the latest good one,
    and a directory without its manifest is not a checkpoint.
  * **Async**: tensors are copied to host memory synchronously, the files
    are written on a background thread; training continues.
  * **Self-describing**: ``manifest.json`` records the step, the tree's
    leaf names, shapes and dtypes; one ``.npy`` per leaf.
  * ``keep_last`` keeps the newest checkpoints and deletes the rest.

Trees are nested dicts, lists and tuples (``NamedTuple`` states by field
name); ``None`` holds no leaf, as in the reference. bf16 leaves, which
numpy cannot hold, are stored as their uint16 bits under the dtype name
``bfloat16``. ``restore`` loads into the structure, devices and dtypes
of a target tree.

  * **Elastic**: ``restore(..., shardings=)`` lays each leaf out on a
    device mesh (a tree of ``distributed.sharding.NamedSharding``): a
    checkpoint saved on one mesh restores onto another. Every rank reads
    the whole leaf and keeps its own shard, so no rank sends a byte.
  * In a process group every rank calls ``save`` (a DTensor leaf is
    gathered whole first, a collective), global rank 0 writes at once
    (never on a thread), and ``save`` returns on every rank after a
    barrier, once the step is published: any rank's ``latest_step`` or
    ``restore`` right after it sees the step whole.
"""

from __future__ import annotations

import json
import os
import re
import shutil
import threading
import time
from typing import Any

import numpy as np
import torch
import torch.distributed as dist

from repro_torch.core.kahan import tree_unflatten

Tree = Any

_MANIFEST = "manifest.json"
_CKPT_RE = re.compile(r"^step_(\d+)$")


def _sanitize(path_str: str) -> str:
    return re.sub(r"[^\w.\-]", "_", path_str)


def _children(node) -> list | None:
    """(name, child) pairs of an inner node, None for a leaf."""
    if isinstance(node, dict):
        return [(str(k), v) for k, v in node.items()]
    if isinstance(node, tuple) and hasattr(node, "_fields"):
        return list(zip(node._fields, node))
    if isinstance(node, (list, tuple)):
        return [(str(i), v) for i, v in enumerate(node)]
    return None


def _flatten_with_names(tree: Tree, prefix: str = "") -> list:
    if tree is None:
        return []
    kids = _children(tree)
    if kids is None:
        return [(prefix or "leaf", tree)]
    out = []
    for name, child in kids:
        out.extend(_flatten_with_names(
            child, f"{prefix}/{name}" if prefix else name))
    return out


def _to_host(leaf) -> tuple[np.ndarray, str]:
    """(numpy array, dtype name) of one leaf."""
    if isinstance(leaf, torch.Tensor):
        t = leaf.detach()
        if hasattr(t, "full_tensor"):             # a DTensor: gather it
            t = t.full_tensor()
        t = t.cpu()
        if t.dtype == torch.bfloat16:
            return t.view(torch.int16).numpy().view(np.uint16), "bfloat16"
        arr = t.numpy()
    else:
        arr = np.asarray(leaf)
    return arr, str(arr.dtype)


def _from_host(arr: np.ndarray, dtype: str, like) -> torch.Tensor:
    if dtype == "bfloat16":
        t = torch.from_numpy(arr.view(np.int16)).view(torch.bfloat16)
    else:
        t = torch.from_numpy(arr)
    return t.to(like.device) if isinstance(like, torch.Tensor) else t


class CheckpointManager:
    def __init__(self, directory: str, *, keep_last: int = 3,
                 async_save: bool = True):
        self.directory = directory
        self.keep_last = keep_last
        self.async_save = async_save
        self._thread: threading.Thread | None = None
        os.makedirs(directory, exist_ok=True)

    # ------------------------------------------------------------ save ----

    def save(self, step: int, tree: Tree, *, extra: dict | None = None
             ) -> None:
        """Snapshot to host, then write: on a thread by default, at once
        in a process group (see the module's docstring). ``extra`` goes
        into the manifest as it is (JSON)."""
        host = [(n, *_to_host(v)) for n, v in _flatten_with_names(tree)]
        in_group = dist.is_initialized()
        if in_group and dist.get_rank() != 0:
            dist.barrier()                   # until rank 0 has published
            return
        manifest = {
            "step": int(step),
            "time": time.time(),
            "extra": extra or {},
            "leaves": [
                {"name": n, "file": f"{i:05d}_{_sanitize(n)[-80:]}.npy",
                 "shape": list(a.shape), "dtype": dt}
                for i, (n, a, dt) in enumerate(host)
            ],
        }

        def _write():
            tmp = os.path.join(self.directory,
                               f".tmp_step_{step}_{os.getpid()}")
            final = os.path.join(self.directory, f"step_{step}")
            shutil.rmtree(tmp, ignore_errors=True)
            os.makedirs(tmp)
            for entry, (_, arr, _) in zip(manifest["leaves"], host):
                np.save(os.path.join(tmp, entry["file"]), arr,
                        allow_pickle=False)
            with open(os.path.join(tmp, _MANIFEST), "w") as f:
                json.dump(manifest, f)
            shutil.rmtree(final, ignore_errors=True)
            os.replace(tmp, final)          # atomic publish
            self._gc()

        self.wait()                          # one save in flight at a time
        if self.async_save and not in_group:
            self._thread = threading.Thread(target=_write, daemon=True)
            self._thread.start()
            return
        try:
            _write()
        finally:
            if in_group:
                dist.barrier()               # the step is published

    def wait(self) -> None:
        if self._thread is not None:
            self._thread.join()
            self._thread = None

    def _gc(self) -> None:
        steps = self.all_steps()
        for s in steps[: max(0, len(steps) - self.keep_last)]:
            shutil.rmtree(os.path.join(self.directory, f"step_{s}"),
                          ignore_errors=True)

    # --------------------------------------------------------- restore ----

    def all_steps(self) -> list[int]:
        out = []
        for d in os.listdir(self.directory):
            m = _CKPT_RE.match(d)
            if m and os.path.exists(os.path.join(self.directory, d,
                                                 _MANIFEST)):
                out.append(int(m.group(1)))
        return sorted(out)

    def latest_step(self) -> int | None:
        steps = self.all_steps()
        return steps[-1] if steps else None

    def restore(self, step: int, target: Tree, shardings: Tree = None
                ) -> Tree:
        """Restore into the structure of ``target``: each leaf comes back
        as a tensor in the dtype it was saved in, on its target's device
        (the CPU for a target leaf that is not a tensor). ``shardings``
        (``target``'s structure, ``NamedSharding`` leaves) re-shards: a
        leaf with a sharding comes back as a DTensor on its mesh's
        device with its spec's placements, every rank holding its own
        slice of the saved tensor. This is the elastic re-mesh path."""
        by_shard = dict(_flatten_with_names(shardings))
        ckpt_dir = os.path.join(self.directory, f"step_{step}")
        with open(os.path.join(ckpt_dir, _MANIFEST)) as f:
            manifest = json.load(f)
        by_name = {e["name"]: e for e in manifest["leaves"]}
        restored = []
        for name, tgt in _flatten_with_names(target):
            entry = by_name.get(name)
            if entry is None:
                raise KeyError(f"checkpoint missing leaf {name!r}")
            arr = np.load(os.path.join(ckpt_dir, entry["file"]),
                          allow_pickle=False)
            expect = tuple(getattr(tgt, "shape", arr.shape))
            if tuple(arr.shape) != expect:
                raise ValueError(f"{name}: shape {arr.shape} != {expect}")
            shd = by_shard.get(name)
            if shd is None:
                restored.append(_from_host(arr, entry["dtype"], tgt))
                continue
            from torch.distributed.tensor import distribute_tensor
            full = _from_host(arr, entry["dtype"], None).to(
                shd.mesh.device_type)
            restored.append(distribute_tensor(full, shd.mesh,
                                              shd.placements(),
                                              src_data_rank=None))
        return tree_unflatten(target, restored)
