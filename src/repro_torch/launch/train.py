"""Training launcher: a decoder-only LM on the synthetic token corpus.

Port of ``src/repro/launch/train.py``::

    PYTHONPATH=src python -m repro_torch.launch.train --arch zamba2_1p2b \\
        --reduced --device cpu --steps 10

Runs on one device: the card unless ``--device cpu`` is given, and
without CUDA it raises unless it is.  There is no mesh and no
``--multi-pod`` (the sharded step is not ported).  Whisper and the VLM are
refused, as the reference refuses them.
"""

from __future__ import annotations

import argparse

import torch

from repro_torch.configs import ARCH_IDS, get_config
from repro_torch.data.pipeline import (
    ColocatedTokenDataset,
    synthetic_token_table,
)
from repro_torch.models.model import build_model, resolve_device
from repro_torch.optim.adamw import AdamWConfig
from repro_torch.optim.schedule import linear_warmup_cosine
from repro_torch.train.step import (
    TrainStepConfig,
    make_train_state,
    make_train_step,
)
from repro_torch.train.trainer import Trainer, TrainerConfig


def main(argv=None):
    ap = argparse.ArgumentParser()
    ap.add_argument("--arch", required=True, choices=ARCH_IDS)
    ap.add_argument("--reduced", action="store_true",
                    help="the arch's smoke config")
    ap.add_argument("--steps", type=int, default=30)
    ap.add_argument("--global-batch", type=int, default=8)
    ap.add_argument("--seq", type=int, default=64)
    ap.add_argument("--microbatches", type=int, default=1)
    ap.add_argument("--ckpt-dir", default=None)
    ap.add_argument("--device", default="cuda")
    args = ap.parse_args(argv)

    device = resolve_device(args.device)
    cfg = get_config(args.arch, reduced=args.reduced)
    if cfg.is_encdec or cfg.family == "vlm":
        raise SystemExit(
            "this token-corpus launcher drives decoder-only LMs; whisper/vlm "
            "train via their tests (stub frontends)")
    model = build_model(cfg)
    print(f"arch={cfg.name} params={cfg.param_count() / 1e6:.1f}M "
          f"device={device}")
    gen = torch.Generator(device=device).manual_seed(0)
    params, opt_state = make_train_state(cfg, model, gen, device)

    table = synthetic_token_table(
        n_rows=max(args.global_batch * 16, 256),
        seq_len=args.seq + 1, vocab=cfg.vocab)
    ds = ColocatedTokenDataset(table, [device], global_batch=args.global_batch)

    schedule = lambda s: linear_warmup_cosine(s, 10, args.steps)  # noqa: E731
    step = make_train_step(
        cfg, model, AdamWConfig(lr=3e-4),
        TrainStepConfig(num_microbatches=args.microbatches,
                        schedule=schedule))
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
