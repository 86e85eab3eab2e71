"""Training launcher: a decoder-only LM on the synthetic token corpus.

Port of ``src/repro/launch/train.py``.  Every rank runs this script; the
parameters lie as ``CellBuilder`` lays them out and the step runs under
its sharding policy, on a mesh over the default process group::

    # one process (a one-rank group is made here)
    PYTHONPATH=src python -m repro_torch.launch.train --arch zamba2_1p2b \\
        --reduced --device cpu --steps 10
    # four ranks on the CPU (gloo), a (data=4, model=1) host mesh
    PYTHONPATH=src torchrun --nproc-per-node 4 -m repro_torch.launch.train \\
        --arch llama3p2_1b --reduced --device cpu

``--reduced`` takes the arch's smoke config on the host mesh
(``(world, 1)``); without it the production mesh
(``--multi-pod``: 2 x 16 x 16), which needs that many ranks.  It runs on
the card unless ``--device cpu`` is given, and without CUDA it raises
unless it is.  Whisper and the VLM are refused, as the reference refuses
them.
"""

from __future__ import annotations

import argparse

import torch

from repro_torch.configs import ARCH_IDS, get_config
from repro_torch.data.pipeline import (
    ColocatedTokenDataset,
    synthetic_token_table,
)
from repro_torch.launch.mesh import (
    ensure_process_group,
    make_host_mesh,
    make_production_mesh,
)
from repro_torch.launch.steps import CellBuilder
from repro_torch.models.model import resolve_device
from repro_torch.models.sharding import use_policy
from repro_torch.optim.adamw import AdamWConfig, adamw_init
from repro_torch.optim.schedule import linear_warmup_cosine
from repro_torch.train.step import TrainStepConfig, make_train_step
from repro_torch.train.trainer import Trainer, TrainerConfig


def main(argv=None):
    ap = argparse.ArgumentParser()
    ap.add_argument("--arch", required=True, choices=ARCH_IDS)
    ap.add_argument("--reduced", action="store_true",
                    help="the arch's smoke config on the host mesh")
    ap.add_argument("--steps", type=int, default=30)
    ap.add_argument("--global-batch", type=int, default=8)
    ap.add_argument("--seq", type=int, default=64)
    ap.add_argument("--microbatches", type=int, default=1)
    ap.add_argument("--ckpt-dir", default=None)
    ap.add_argument("--multi-pod", action="store_true")
    ap.add_argument("--device", default="cuda")
    args = ap.parse_args(argv)

    device = resolve_device(args.device)
    cfg = get_config(args.arch, reduced=args.reduced)
    if cfg.is_encdec or cfg.family == "vlm":
        raise SystemExit(
            "this token-corpus launcher drives decoder-only LMs; whisper/vlm "
            "train via their dry-run cells and tests (stub frontends)")
    ensure_process_group(device.type)
    mesh = (make_host_mesh(device_type=device.type) if args.reduced
            else make_production_mesh(multi_pod=args.multi_pod,
                                      device_type=device.type))
    builder = CellBuilder(cfg, mesh, "train")
    model = builder.model
    print(f"arch={cfg.name} params={cfg.param_count() / 1e6:.1f}M "
          f"mesh={dict(zip(mesh.mesh_dim_names, mesh.shape))}")
    gen = torch.Generator(device=device).manual_seed(0)
    params = builder.place_params(model.init(gen, device))
    opt_state = adamw_init(params)

    n_rows = max(args.global_batch * 16, 256)
    # regions small enough that every data rank is given some (four each)
    shards = mesh.size() // mesh.size(mesh.mesh_dim_names.index("model"))
    table = synthetic_token_table(
        n_rows=n_rows, seq_len=args.seq + 1, vocab=cfg.vocab,
        region_bytes=min(1 << 22, n_rows * (args.seq + 2) * 4 // (4 * shards)))
    ds = ColocatedTokenDataset(table, mesh, global_batch=args.global_batch)

    schedule = lambda s: linear_warmup_cosine(s, 10, args.steps)  # noqa: E731
    raw_step = make_train_step(
        cfg, model, AdamWConfig(lr=3e-4),
        TrainStepConfig(num_microbatches=args.microbatches,
                        schedule=schedule))

    def step(p, o, b, i):
        with use_policy(builder.policy):
            return raw_step(p, o, b, i)

    trainer = Trainer(step, ds, TrainerConfig(
        total_steps=args.steps, log_every=5,
        checkpoint_every=max(args.steps // 2, 1),
        checkpoint_dir=args.ckpt_dir))
    params, opt_state, history = trainer.run(params, opt_state)
    print(f"done: loss {history[0]['loss']:.3f} -> "
          f"{history[-1]['loss']:.3f}")
    return history


if __name__ == "__main__":
    main()
