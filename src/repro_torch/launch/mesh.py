"""Device meshes over the process group that exists.

Port of ``src/repro/launch/mesh.py``.  ``jax.make_mesh`` becomes
``init_device_mesh`` over the default process group: ranks launched by
``torchrun``, a one-rank group made here (:func:`ensure_process_group`),
or a ``fake`` group of world size 256 or 512 for the dry run
(:func:`fake_process_group`), where no rank but this one exists and
collectives move nothing.  Functions, never module-level constants:
importing this module touches no process group.
"""

from __future__ import annotations

import os
import socket
import torch
import torch.distributed as dist


def _free_port() -> int:
    with socket.socket() as s:
        s.bind(("localhost", 0))
        return s.getsockname()[1]


def ensure_process_group(device_type: str) -> None:
    """The default process group: as ``torchrun`` describes it in the
    environment, else one rank on ``localhost`` (NCCL for ``"cuda"``, gloo
    for ``"cpu"``).  Does nothing when one exists."""
    if dist.is_initialized():
        return
    backend = "nccl" if device_type == "cuda" else "gloo"
    if "RANK" in os.environ and "WORLD_SIZE" in os.environ:
        if device_type == "cuda":
            torch.cuda.set_device(int(os.environ.get("LOCAL_RANK", 0)))
        dist.init_process_group(backend)
        return
    if device_type == "cuda":
        torch.cuda.set_device(0)
    dist.init_process_group(backend, init_method=f"tcp://localhost:"
                            f"{_free_port()}", rank=0, world_size=1)


def fake_process_group(world_size: int) -> None:
    """A ``fake`` default group of ``world_size`` ranks, this process being
    rank 0: the stand-in for a cluster in the dry run (the counterpart of
    ``--xla_force_host_platform_device_count``)."""
    from torch.testing._internal.distributed.fake_pg import FakeStore

    if dist.is_initialized():
        if dist.get_world_size() == world_size:
            return
        dist.destroy_process_group()
    dist.init_process_group("fake", store=FakeStore(), rank=0,
                            world_size=world_size)


def make_production_mesh(*, device_type: str, multi_pod: bool = False):
    """16 x 16 = 256 ranks per pod as ``("data", "model")``; two pods, 512
    ranks, as ``("pod", "data", "model")``.  The default group must have
    that many ranks."""
    from torch.distributed.device_mesh import init_device_mesh

    shape = (2, 16, 16) if multi_pod else (16, 16)
    axes = ("pod", "data", "model") if multi_pod else ("data", "model")
    return init_device_mesh(device_type, shape, mesh_dim_names=axes)


def make_host_mesh(*, device_type: str, model: int = 1):
    """``(world // model, model)`` as ``("data", "model")`` over the
    default group (made here with one rank if there is none)."""
    from torch.distributed.device_mesh import init_device_mesh

    ensure_process_group(device_type)
    n = dist.get_world_size()
    if n % model:
        raise ValueError(f"{n} ranks do not split into model={model}")
    return init_device_mesh(device_type, (n // model, model),
                            mesh_dim_names=("data", "model"))
