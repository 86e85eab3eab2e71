"""Checkpointing: atomic step directories, async writes, retention.

Port of ``src/repro/ckpt/checkpoint.py``, with its on-disk format:

- a checkpoint is a directory ``step_<N>/`` (N zero-padded to 9 digits)
  holding ``arrays.npz`` (one array per leaf, keyed by the leaf's path:
  dict keys and list indices joined by ``/``) and ``manifest.json`` (the
  step, the sorted keys, each key's shape and dtype name, user metadata);
- writes go to ``step_<N>.tmp`` and are renamed into place, so a crash
  mid-save never leaves a half-written step that :func:`latest_step`
  would find;
- ``CheckpointManager.save`` copies the tree to host memory before it
  returns (so training may update its tensors in place at once) and
  writes on a background thread;
- retention keeps the last K steps (plus every ``keep_every``-th).

Either package restores the other's checkpoints.  bf16 leaves are written
as their raw two-byte patterns (numpy's ``V2``), the bytes the reference's
``ml_dtypes`` arrays give ``np.savez``, and read back by the manifest's
dtype name.

:func:`restore_checkpoint` returns tensors on each template leaf's device
and in its dtype, and a DTensor with the template leaf's mesh and
placements where the template leaf is one: the reference's
``shardings=`` re-placement.  A DTensor leaf is saved as its global
value (a collective that every rank joins); only rank 0 of a process
group writes.
"""

from __future__ import annotations

import json
import os
import re
import shutil
import threading
from typing import Any, Dict, List, Optional, Tuple

import numpy as np
import torch

from repro_torch.utils import (
    tree_flatten,
    tree_leaves_with_path,
    tree_unflatten,
)

PyTree = Any

_SEP = "/"

#: dtype names of the manifest, as numpy (and ``ml_dtypes``) spell them
_TORCH_DTYPES = {
    "float64": torch.float64, "float32": torch.float32,
    "float16": torch.float16, "bfloat16": torch.bfloat16,
    "int64": torch.int64, "int32": torch.int32, "int16": torch.int16,
    "int8": torch.int8, "uint8": torch.uint8, "bool": torch.bool,
}
_DTYPE_NAMES = {v: k for k, v in _TORCH_DTYPES.items()}


def _key(path) -> str:
    return _SEP.join(str(k) for k in path)


def _to_host(leaf) -> Tuple[np.ndarray, str]:
    """A leaf as a host array that owns its memory, and its dtype name."""
    if hasattr(leaf, "full_tensor"):            # a DTensor: its global value
        leaf = leaf.full_tensor()
    if isinstance(leaf, torch.Tensor):
        t = leaf.detach().to("cpu", copy=True)
        if t.dtype == torch.bfloat16:
            return t.view(torch.int16).numpy().view("V2"), "bfloat16"
        return t.numpy(), _DTYPE_NAMES[t.dtype]
    arr = np.array(leaf)
    return arr, str(arr.dtype)


def _rank() -> int:
    import torch.distributed as dist
    return dist.get_rank() if dist.is_initialized() else 0


def _place(t: torch.Tensor, leaf) -> torch.Tensor:
    """``t`` (a host tensor) on the template leaf's device, dtype and, for
    a DTensor leaf, mesh and placements (each rank keeps its shards)."""
    if hasattr(leaf, "device_mesh"):
        from torch.distributed.tensor import distribute_tensor
        mesh = leaf.device_mesh
        t = t.to(device=mesh.device_type, dtype=leaf.dtype)
        return distribute_tensor(t, mesh, leaf.placements,
                                 src_data_rank=None)
    return t.to(device=leaf.device, dtype=leaf.dtype)


def _flatten(tree: PyTree) -> Dict[str, Tuple[np.ndarray, str]]:
    return {_key(path): _to_host(leaf)
            for path, leaf in tree_leaves_with_path(tree)}


def save_checkpoint(
    directory: str,
    step: int,
    tree: PyTree,
    metadata: Optional[Dict] = None,
) -> str:
    """Atomic synchronous save.  Returns the final step directory."""
    return _write(directory, step, _flatten(tree), metadata)


def _write(directory: str, step: int,
           flat: Dict[str, Tuple[np.ndarray, str]],
           metadata: Optional[Dict]) -> str:
    final = os.path.join(directory, f"step_{step:09d}")
    if _rank() != 0:
        return final
    os.makedirs(directory, exist_ok=True)
    tmp = final + ".tmp"
    if os.path.exists(tmp):
        shutil.rmtree(tmp)
    os.makedirs(tmp)

    np.savez(os.path.join(tmp, "arrays.npz"),
             **{k: v for k, (v, _) in flat.items()})
    manifest = {
        "step": step,
        "keys": sorted(flat.keys()),
        "shapes": {k: list(v.shape) for k, (v, _) in flat.items()},
        "dtypes": {k: name for k, (_, name) in flat.items()},
        "metadata": metadata or {},
    }
    with open(os.path.join(tmp, "manifest.json"), "w") as f:
        json.dump(manifest, f)
    if os.path.exists(final):
        shutil.rmtree(final)
    os.rename(tmp, final)
    return final


def _as_tensor(arr: np.ndarray, name: str) -> torch.Tensor:
    arr = np.array(arr)        # a writable copy; keeps 0-d arrays 0-d
    if name == "bfloat16":
        return torch.from_numpy(arr.view(np.int16)).view(torch.bfloat16)
    return torch.from_numpy(arr)


def restore_checkpoint(
    directory: str,
    template: PyTree,
    step: Optional[int] = None,
) -> Tuple[PyTree, Dict]:
    """Restore into ``template``'s structure -> (tree, metadata).

    Each leaf comes back as a tensor on the template leaf's device and in
    its dtype; a shape mismatch against the template raises (a config
    error, not a silent reshape)."""
    if step is None:
        step = latest_step(directory)
        if step is None:
            raise FileNotFoundError(f"no checkpoints under {directory}")
    d = os.path.join(directory, f"step_{step:09d}")
    with open(os.path.join(d, "manifest.json")) as f:
        manifest = json.load(f)
    leaves_out: List[torch.Tensor] = []
    _, treedef = tree_flatten(template)
    with np.load(os.path.join(d, "arrays.npz")) as data:
        for path, leaf in tree_leaves_with_path(template):
            key = _key(path)
            if key not in data:
                raise KeyError(f"checkpoint missing {key!r}")
            arr = data[key]
            want_shape = tuple(leaf.shape)
            if arr.shape != want_shape:
                raise ValueError(f"{key}: checkpoint shape {arr.shape} != "
                                 f"template {want_shape}")
            leaves_out.append(_place(_as_tensor(arr, manifest["dtypes"][key]),
                                     leaf))
    return tree_unflatten(treedef, leaves_out), manifest["metadata"]


def latest_step(directory: str) -> Optional[int]:
    if not os.path.isdir(directory):
        return None
    steps = []
    for name in os.listdir(directory):
        m = re.fullmatch(r"step_(\d+)", name)
        if m:
            steps.append(int(m.group(1)))
    return max(steps) if steps else None


class CheckpointManager:
    """Retention + async writes.

    ``save(step, tree)``: copy to host now, write in the background.
    ``wait()``: join outstanding writes (call before process exit).
    """

    def __init__(
        self,
        directory: str,
        keep_last: int = 3,
        keep_every: Optional[int] = None,
    ):
        self.directory = directory
        self.keep_last = keep_last
        self.keep_every = keep_every
        self._thread: Optional[threading.Thread] = None
        self._error: Optional[BaseException] = None

    def save(self, step: int, tree: PyTree, metadata: Optional[Dict] = None,
             async_: bool = True) -> None:
        self.wait()  # one outstanding write at a time
        flat = _flatten(tree)

        def work():
            try:
                _write(self.directory, step, flat, metadata)
                if _rank() == 0:
                    self._gc()
            except BaseException as e:  # surfaced on next wait()
                self._error = e

        if async_:
            self._thread = threading.Thread(target=work, daemon=True)
            self._thread.start()
        else:
            work()
            self._raise_if_failed()

    def wait(self) -> None:
        if self._thread is not None:
            self._thread.join()
            self._thread = None
        self._raise_if_failed()

    def restore(self, template: PyTree, step: Optional[int] = None):
        self.wait()
        return restore_checkpoint(self.directory, template, step)

    def latest_step(self) -> Optional[int]:
        self.wait()
        return latest_step(self.directory)

    # ------------------------------------------------------------------

    def _raise_if_failed(self):
        if self._error is not None:
            err, self._error = self._error, None
            raise RuntimeError("async checkpoint write failed") from err

    def _gc(self):
        steps = sorted(
            int(m.group(1))
            for name in os.listdir(self.directory)
            if (m := re.fullmatch(r"step_(\d+)", name))
        )
        keep = set(steps[-self.keep_last:])
        if self.keep_every:
            keep |= {s for s in steps if s % self.keep_every == 0}
        for s in steps:
            if s not in keep:
                shutil.rmtree(os.path.join(self.directory, f"step_{s:09d}"),
                              ignore_errors=True)
