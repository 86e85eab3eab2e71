"""Step builders and their layouts for the dry run and the launchers.

Port of ``src/repro/launch/steps.py``.  One place decides, per (arch x
shape kind), WHAT function runs and HOW its inputs lie on the mesh.
Training splits the batch over (pod, data) and the parameters by the
FSDP + TP rules; decode also splits the KV cache's *sequence* dim over
``model`` (the flash-decode layout).  The reference's ``NamedSharding``s
become DTensor placements (``models/params.py``): :meth:`CellBuilder.build`
returns the step, ``meta`` stand-ins of its arguments and their
placements, and :meth:`CellBuilder.place` turns full tensors (or the
stand-ins, under ``FakeTensorMode``) into the DTensors the step takes.
"""

from __future__ import annotations

from typing import Any, Dict, Tuple

import torch

from repro_torch.models.config import ModelConfig
from repro_torch.models.model import build_model
from repro_torch.models.params import (
    _zip_axes,
    mesh_shape,
    placements,
    resolve_spec,
    resolve_tree,
    sharding_rules,
)
from repro_torch.models.sharding import ShardingPolicy, use_policy
from repro_torch.optim.adamw import AdamWConfig, adamw_init
from repro_torch.train.loss import cross_entropy, encdec_loss
from repro_torch.train.step import TrainStepConfig, make_train_step


def rules_for(kind: str, fsdp: bool = True) -> Dict:
    rules = sharding_rules(fsdp=fsdp)
    if kind == "decode":
        # shard the cache's sequence over the model axis (flash decode)
        rules = dict(rules)
        rules["seq"] = ("model",)
    return rules


def tree_specs(shapes_tree, axes_tree, rules, mesh) -> Any:
    """The reference's ``PartitionSpec`` (as tuples) of every leaf."""
    return resolve_tree(shapes_tree, axes_tree, rules, mesh)


def batch_spec(mesh) -> Tuple:
    axes = tuple(a for a in ("pod", "data") if a in mesh.mesh_dim_names)
    return ((axes if len(axes) > 1 else axes[0]),)


def place(t: torch.Tensor, pl, mesh):
    """A full tensor as a DTensor with placements ``pl``; every rank holds
    the same ``t`` and keeps its shards (no data moves)."""
    from torch.distributed.tensor import distribute_tensor
    return distribute_tensor(t, mesh, pl, src_data_rank=None)


class CellBuilder:
    """Builds (fn, argument stand-ins, placements, donated args) for one
    cell: the train step, prefill or one decode step of ``cfg`` on
    ``mesh`` under the cell kind's rules."""

    def __init__(self, cfg: ModelConfig, mesh, kind: str):
        self.cfg = cfg
        self.mesh = mesh
        self.kind = kind
        self.model = build_model(cfg)
        self.rules = rules_for(kind)
        self.policy = ShardingPolicy(mesh, self.rules)
        self.param_shapes = self.model.init(device="meta")
        self.param_axes = self.model.logical_axes()
        self.param_specs = tree_specs(self.param_shapes, self.param_axes,
                                      self.rules, mesh)
        self.param_pl = self._placements(self.param_shapes, self.param_axes)

    def _placements(self, shapes, axes):
        shape = mesh_shape(self.mesh)
        return _zip_axes(lambda s, a: placements(resolve_spec(
            tuple(s.shape), a, self.rules, shape), self.mesh), shapes, axes)

    def input_pl(self, t, axes) -> Tuple:
        """Divisibility-aware placements of one input (batch 1 stays
        replicated)."""
        return placements(resolve_spec(tuple(t.shape), axes, self.rules,
                                       mesh_shape(self.mesh)), self.mesh)

    def opt_placements(self):
        rep = self.input_pl(torch.empty(()), ())
        return {"m": self.param_pl, "v": self.param_pl, "step": rep}

    # ------------------------------------------------------------------

    def place_params(self, params):
        return self.place(params, self.param_pl)

    def place(self, args, pls):
        """Every tensor of ``args`` as a DTensor with its placements in
        ``pls`` (the same structure); other leaves pass through."""
        def walk(a, pl):
            if isinstance(a, dict):
                return {k: walk(a[k], pl[k]) for k in a}
            if isinstance(a, (list, tuple)) and not _is_pl(pl):
                out = [walk(x, p) for x, p in zip(a, pl)]
                return tuple(out) if isinstance(a, tuple) else out
            if isinstance(a, torch.Tensor) and pl is not None:
                return place(a, pl, self.mesh)
            return a
        return walk(args, pls)

    def build(self, specs: Dict[str, Any]):
        """-> (fn, argument stand-ins, placements, donated argnums)."""
        cfg, model, policy = self.cfg, self.model, self.policy
        step_idx = torch.zeros((), dtype=torch.int32, device="meta")
        rep = self.input_pl(step_idx, ())

        if self.kind == "train":
            opt_shapes = adamw_init(self.param_shapes)
            opt_pl = self.opt_placements()
            step_cfg = TrainStepConfig(num_microbatches=cfg.train_microbatches)

            def make(loss_fn=None):
                inner = make_train_step(cfg, model, AdamWConfig(), step_cfg,
                                        loss_fn=loss_fn)

                def step(params, opt_state, *batch_and_idx):
                    *batch, idx = batch_and_idx
                    with use_policy(policy):
                        return inner(params, opt_state,
                                     batch[0] if len(batch) == 1
                                     else tuple(batch), idx)
                return step

            if cfg.is_encdec:
                frames_t = specs["frames"]

                def fn(params, opt_state, frames, tokens, idx):
                    return make(lambda p, toks: encdec_loss(
                        cfg, model, p, frames, toks))(params, opt_state,
                                                      tokens, idx)

                args = (self.param_shapes, opt_shapes, frames_t,
                        specs["tokens"], step_idx)
                pls = (self.param_pl, opt_pl,
                       self.input_pl(frames_t, ("batch", None, None)),
                       self.input_pl(specs["tokens"], ("batch", "seq")), rep)
                return fn, args, pls, (0, 1)

            if cfg.family == "vlm":
                def loss_fn(p, batch):
                    embeds, positions, targets = batch
                    logits, aux = model.forward_train(
                        p, embeds=embeds, positions=positions)
                    return cross_entropy(logits, targets) + 0.0 * aux, \
                        {"aux": aux}

                args = (self.param_shapes, opt_shapes, specs["embeds"],
                        specs["positions"], specs["targets"], step_idx)
                pls = (self.param_pl, opt_pl,
                       self.input_pl(specs["embeds"],
                                     ("batch", "seq", "embed_act")),
                       self.input_pl(specs["positions"],
                                     ("batch", None, "seq")),
                       self.input_pl(specs["targets"], ("batch", "seq")),
                       rep)
                return make(loss_fn), args, pls, (0, 1)

            args = (self.param_shapes, opt_shapes, specs["tokens"], step_idx)
            pls = (self.param_pl, opt_pl,
                   self.input_pl(specs["tokens"], ("batch", "seq")), rep)
            return make(), args, pls, (0, 1)

        if self.kind == "prefill":
            if cfg.is_encdec:
                def fn(params, frames, tokens):
                    with use_policy(policy):
                        return model.prefill(params, frames, tokens)
                args = (self.param_shapes, specs["frames"], specs["tokens"])
                pls = (self.param_pl,
                       self.input_pl(specs["frames"], ("batch", None, None)),
                       self.input_pl(specs["tokens"], ("batch", "seq")))
                return fn, args, pls, ()
            if cfg.family == "vlm":
                def fn(params, embeds):
                    with use_policy(policy):
                        return model.prefill(params, embeds=embeds)
                args = (self.param_shapes, specs["embeds"])
                pls = (self.param_pl,
                       self.input_pl(specs["embeds"],
                                     ("batch", "seq", "embed_act")))
                return fn, args, pls, ()

            def fn(params, tokens):
                with use_policy(policy):
                    return model.prefill(params, tokens)
            args = (self.param_shapes, specs["tokens"])
            pls = (self.param_pl,
                   self.input_pl(specs["tokens"], ("batch", "seq")))
            return fn, args, pls, ()

        # decode
        cache_pl = self._placements(specs["caches"], self.model.cache_axes())

        def fn(params, caches, token, pos):
            with use_policy(policy):
                logits, new_caches = model.decode_step(params, token, pos,
                                                       caches)
                # the argmax over the vocab runs on whole rows
                logits = policy.constrain(logits, ("batch", None))
                next_tok = torch.argmax(logits, dim=-1).to(torch.int32)
                return next_tok, new_caches

        args = (self.param_shapes, specs["caches"], specs["token"],
                specs["pos"])
        pls = (self.param_pl, cache_pl,
               self.input_pl(specs["token"], ("batch",)),
               self.input_pl(specs["pos"], ("batch",)))
        return fn, args, pls, (1,)


def _is_pl(x) -> bool:
    from torch.distributed.tensor import Placement
    return isinstance(x, tuple) and all(isinstance(p, Placement) for p in x)
