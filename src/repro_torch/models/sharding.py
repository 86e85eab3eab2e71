"""Activation-sharding policy: logical constraints inside model code.

Port of ``src/repro/models/sharding.py``.  Model code calls
``constrain(x, ("batch", "seq", "embed_act"))`` at block boundaries;
outside any policy that is the identity (one card, the CPU tests), and
under a :class:`ShardingPolicy` (installed by the launcher, the step
builder or the dry run) it redistributes the DTensor ``x`` to the
placements that the policy's rules resolve, the counterpart of
``with_sharding_constraint``.  The rules table is the one the parameters
use, so a layout change is one rule, not a model edit.
"""

from __future__ import annotations

import contextlib
import contextvars
from typing import Any, Mapping, Optional, Sequence, Tuple

import torch

from repro_torch.models.params import (
    is_axes_leaf,
    mesh_shape,
    placements,
    resolve_spec,
)

_POLICY: contextvars.ContextVar[Optional["ShardingPolicy"]] = \
    contextvars.ContextVar("cologrid_sharding_policy", default=None)

#: the storage-only mesh axes that ``compute_view`` gathers away
STORAGE_AXES = ("data", "pod")


class ShardingPolicy:
    def __init__(self, mesh, rules: Mapping[Optional[str], Tuple[str, ...]]):
        self.mesh = mesh
        self.rules = dict(rules)
        self.compute_rules = {k: tuple(a for a in v if a not in STORAGE_AXES)
                              for k, v in self.rules.items()}
        self.shape = mesh_shape(mesh)

    def placements_for(self, shape: Sequence[int],
                       names: Sequence[Optional[str]],
                       compute: bool = False) -> Tuple:
        rules = self.compute_rules if compute else self.rules
        return placements(resolve_spec(tuple(shape), tuple(names), rules,
                                       self.shape), self.mesh)

    def batch_axes(self) -> Tuple[str, ...]:
        """The mesh axes the batch is split over (size > 1 only)."""
        return tuple(a for a in self.rules.get("batch", ())
                     if self.shape.get(a, 1) > 1)

    def constrain(self, x, names: Sequence[Optional[str]]):
        """``x`` redistributed to the resolved placements; a plain tensor
        (one that every rank made alike) is split there without moving
        data."""
        pl = self.placements_for(x.shape, names)
        if not is_dtensor(x):
            from torch.distributed.tensor import distribute_tensor
            return distribute_tensor(x, self.mesh, pl, src_data_rank=None)
        if x.requires_grad:
            x = _GradLike.apply(x)
        return _redistribute(x, pl)


def _redistribute(x, pl):
    if tuple(x.placements) == tuple(pl):
        return x
    return x.redistribute(x.device_mesh, pl)


@contextlib.contextmanager
def use_policy(policy: Optional[ShardingPolicy]):
    """Install ``policy`` for model code.  Under a policy, plain tensors
    that model code makes (positions, masks, zeros) count as replicated
    beside DTensors: every rank makes the same ones."""
    token = _POLICY.set(policy)
    if policy is None:
        try:
            yield
        finally:
            _POLICY.reset(token)
        return
    # DTensor's implicit_replication() switches the flag off on exit, also
    # for an enclosing policy (the remat recompute enters one on
    # autograd's thread while the step's is open): save and restore it
    from torch.distributed.tensor import DTensor

    dispatcher = DTensor._op_dispatcher
    before = dispatcher._allow_implicit_replication
    dispatcher._allow_implicit_replication = True
    try:
        yield
    finally:
        dispatcher._allow_implicit_replication = before
        _POLICY.reset(token)


def current_policy() -> Optional[ShardingPolicy]:
    return _POLICY.get()


def constrain(x, names: Sequence[Optional[str]]):
    """Apply the active policy's constraint, or pass through."""
    pol = _POLICY.get()
    if pol is None:
        return x
    return pol.constrain(x, names)


def compute_view(params: Any, axes_tree: Any) -> Any:
    """FSDP storage -> compute layout: redistribute a parameter subtree
    with the ``data``/``pod`` (storage) axes dropped, the just-in-time
    weight all-gather.  The identity outside a policy."""
    pol = _POLICY.get()
    if pol is None:
        return params

    def walk(w, ax):
        if isinstance(w, dict):       # leaves without axes pass through
            return {k: walk(v, ax[k]) if k in ax else v for k, v in w.items()}
        if ax is None or not is_axes_leaf(ax):
            return w
        return _redistribute(w, pol.placements_for(w.shape, ax,
                                                   compute=True))

    return walk(params, axes_tree)


def split_last(t: torch.Tensor, *sizes: int) -> torch.Tensor:
    """``t`` with its last dim split into ``sizes`` (heads x head dim).
    A DTensor split over mesh dims that ``sizes[0]`` does not divide (8 KV
    heads on a 16-way ``model`` axis) is gathered over them first: DTensor
    cannot split a sharded dim unevenly."""
    if is_dtensor(t):
        from torch.distributed.tensor import Replicate

        pl = list(t.placements)
        ways = 1
        for j, p in enumerate(pl):
            if p.is_shard(t.dim() - 1):
                n = t.device_mesh.size(j)
                if sizes[0] % (ways * n):
                    pl[j] = Replicate()
                else:
                    ways *= n
        if pl != list(t.placements):
            t = t.redistribute(t.device_mesh, pl)
    return t.reshape(*t.shape[:-1], *sizes)


def shard_sum(x: torch.Tensor) -> torch.Tensor:
    """The sum of all of ``x``'s elements.  On a DTensor the backward
    hands each rank the gradient of its own shard: DTensor's own sum
    would start the backward from a replicated gradient and carry whole
    activations through it."""
    if not is_dtensor(x):
        return x.sum()
    from torch.distributed.tensor import Partial

    out = tuple(Partial() if p.is_shard() else p for p in x.placements)
    return local_call(lambda t: t.sum(), (x,), (x.placements,), out)


def merge_last(t: torch.Tensor, n: int = 2) -> torch.Tensor:
    """``t`` with its last ``n`` dims merged into one (heads x head dim ->
    width), the inverse of :func:`split_last`."""
    out = t.reshape(*t.shape[:-n], -1)
    if is_dtensor(out) and out.requires_grad:
        out = _GradLike.apply(out)
    return out


def is_dtensor(x) -> bool:
    from torch.distributed.tensor import DTensor
    return isinstance(x, DTensor)


class _GradLike(torch.autograd.Function):
    """The identity whose backward lays the gradient out as the forward
    value was: a DTensor's placements, then contiguous.  DTensor reshapes
    a gradient with ``view``, which neither a transposed local gradient
    (what a kernel's ``[B, H, S, D]`` view hands back) nor one cut out of
    an uneven redistribution's padded buffer can take, and a gradient
    split over a dim that a merged dim cannot be split back into would
    stop the backward of the merge."""

    @staticmethod
    def forward(ctx, x):
        ctx.layout = None
        if is_dtensor(x):           # a partial value's gradient is whole
            from torch.distributed.tensor import Replicate
            ctx.layout = (x.device_mesh, tuple(
                Replicate() if p.is_partial() else p for p in x.placements))
        return x.view_as(x)

    @staticmethod
    def backward(ctx, g):
        if ctx.layout is None:
            return g.contiguous()
        if tuple(g.placements) != ctx.layout[1]:
            g = g.redistribute(*ctx.layout)
        local = g.to_local()
        if local.is_contiguous():     # a DTensor's own contiguous() looks
            return g                  # at its global strides only
        from torch.distributed.tensor import DTensor
        return DTensor.from_local(local.contiguous(), g.device_mesh,
                                  g.placements, run_check=False,
                                  shape=g.shape, stride=g.stride())


def _contiguous_grads(fn):
    def wrapped(*args):
        return fn(*[_GradLike.apply(a) if isinstance(a, torch.Tensor)
                    and a.requires_grad else a for a in args])
    return wrapped


def local_call(fn, args: Sequence[Any], in_placements: Sequence[Any],
               out_placements: Any):
    """``fn`` on the local shards of DTensor ``args``, redistributed to
    ``in_placements`` first (``None`` for a non-tensor argument), its
    outputs wrapped back with ``out_placements``: the counterpart of
    ``shard_map``, for ops that have no DTensor sharding rule (the CUDA
    kernels, the MoE dispatch, the RWKV time loop).  With no policy, or
    no DTensor among ``args``, it is ``fn(*args)``.

    An input replicated over a mesh dim that an output is split (or
    partial) over feeds a split computation, so its gradient is a partial
    sum over that dim; every other gradient takes its input's
    placements."""
    pol = _POLICY.get()
    if pol is None or not any(is_dtensor(a) for a in args):
        return fn(*args)
    from torch.distributed.tensor import (
        DTensor,
        Partial,
        Placement,
        Replicate,
    )
    from torch.distributed.tensor.experimental import local_map

    rep = [Replicate()] * pol.mesh.ndim
    args = [DTensor.from_local(a, pol.mesh, rep, run_check=False)
            if isinstance(a, torch.Tensor) and not is_dtensor(a) else a
            for a in args]
    # local_map reads a tuple as one entry per output, a list as the
    # placements of the single output
    single = all(isinstance(p, Placement) for p in out_placements)
    outs = [out_placements] if single else list(out_placements)
    split = [any(not o[j].is_replicate() for o in outs)
             for j in range(pol.mesh.ndim)]
    grad_pl = tuple(
        None if pl is None else tuple(
            Partial() if split[j] and p.is_replicate() else p
            for j, p in enumerate(pl))
        for pl in in_placements)
    out_placements = (list(out_placements) if single
                      else tuple(list(p) for p in out_placements))
    return local_map(_contiguous_grads(fn), out_placements=out_placements,
                     in_placements=tuple(in_placements),
                     in_grad_placements=grad_pl,
                     redistribute_inputs=True,
                     device_mesh=pol.mesh)(*args)


def mesh_coordinate(axis: str) -> int:
    """This rank's index along mesh axis ``axis`` of the active policy
    (0 without one, or when the mesh has no such axis)."""
    pol = _POLICY.get()
    if pol is None or axis not in pol.shape:
        return 0
    return pol.mesh.get_local_rank(axis)
