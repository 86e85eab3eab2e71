"""Serving launcher: random weights from a seed, batched prefill + decode.

Port of ``src/repro/launch/serve.py``::

    PYTHONPATH=src python -m repro_torch.launch.serve --arch zamba2_1p2b \
        --batch 8 --prompt-len 2048 --new-tokens 64

Runs on the card; ``--device cpu`` (with ``--reduced`` for the smoke
configs) runs it on the CPU.  Without CUDA and without ``--device cpu`` it
raises.  It serves every decoder-only family; for an encoder-decoder model
(whisper) it stops, as the reference does: drive ``EncDecModel.prefill``
and ``decode_step`` instead.
"""

from __future__ import annotations

import argparse
import time

import torch

from repro_torch.configs import ARCH_IDS, get_config
from repro_torch.models.model import build_model
from repro_torch.serve.engine import ServeEngine


def main(argv=None):
    ap = argparse.ArgumentParser()
    ap.add_argument("--arch", required=True, choices=ARCH_IDS)
    ap.add_argument("--reduced", action="store_true")
    ap.add_argument("--batch", type=int, default=4)
    ap.add_argument("--prompt-len", type=int, default=12)
    ap.add_argument("--new-tokens", type=int, default=16)
    ap.add_argument("--temperature", type=float, default=0.0)
    ap.add_argument("--seed", type=int, default=0)
    ap.add_argument("--device", default="cuda")
    args = ap.parse_args(argv)

    device = torch.device(args.device)
    if device.type == "cuda" and not torch.cuda.is_available():
        raise RuntimeError("no CUDA device: pass --device cpu to serve on "
                           "the CPU")
    cfg = get_config(args.arch, reduced=args.reduced)
    if cfg.is_encdec:
        raise SystemExit("the serving engine does not serve encoder-decoder "
                         "models: drive EncDecModel.prefill / decode_step")
    model = build_model(cfg)
    gen = torch.Generator(device=device).manual_seed(args.seed)
    params = model.init(gen, device)
    print(f"arch={cfg.name} params={cfg.param_count() / 1e6:.1f}M "
          f"device={device}")
    prompts = torch.randint(0, cfg.vocab, (args.batch, args.prompt_len),
                            generator=gen, device=device,
                            dtype=torch.int32).cpu().numpy()
    engine = ServeEngine(cfg, params,
                         capacity=args.prompt_len + args.new_tokens + 1,
                         batch_size=args.batch, device=device)
    del params
    t0 = time.perf_counter()
    out = engine.generate(prompts, args.new_tokens,
                          temperature=args.temperature, seed=args.seed)
    dt = time.perf_counter() - t0
    print(f"{args.batch} requests x {args.new_tokens} tokens in {dt:.2f}s: "
          f"prefill {out.prefill_s:.3f}s, decode "
          f"{args.batch * (args.new_tokens - 1) / max(out.decode_s, 1e-9):.0f}"
          f" tok/s")
    for b in range(min(args.batch, 4)):
        print(f"  req {b}: ...{prompts[b, -4:].tolist()} -> "
              f"{out.tokens[b, :12].tolist()}...")
    return out


if __name__ == "__main__":
    main()
