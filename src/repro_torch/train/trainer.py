"""Trainer loop: data from the colocation grid, periodic checkpoints,
failure/straggler hooks wired to the GridScheduler.

Port of ``src/repro/train/trainer.py``.  The loop is deliberately thin —
the heavy lifting is in the step — but it owns the operational concerns:
resume from the latest checkpoint (restored onto the devices and dtypes
of the parameters it was handed), checkpoint cadence, metric logging,
and the final save and ``wait()``.
"""

from __future__ import annotations

import dataclasses
import time
from typing import Any, Callable, Dict, List, Optional

from repro_torch.ckpt.checkpoint import CheckpointManager
from repro_torch.core.scheduler import GridScheduler

PyTree = Any


@dataclasses.dataclass
class TrainerConfig:
    total_steps: int = 100
    log_every: int = 10
    checkpoint_every: int = 50
    checkpoint_dir: Optional[str] = None
    keep_last: int = 3


class Trainer:
    def __init__(
        self,
        step_fn: Callable,              # (p, o, batch, i) -> (p, o, m)
        dataset,                        # ColocatedTokenDataset-like
        cfg: TrainerConfig,
        scheduler: Optional[GridScheduler] = None,
    ):
        self.step_fn = step_fn
        self.dataset = dataset
        self.cfg = cfg
        self.scheduler = scheduler
        self.ckpt = (CheckpointManager(cfg.checkpoint_dir, cfg.keep_last)
                     if cfg.checkpoint_dir else None)
        self.history: List[Dict[str, float]] = []

    def run(self, params: PyTree, opt_state: PyTree):
        start = 0
        if self.ckpt is not None:
            latest = self.ckpt.latest_step()
            if latest is not None:
                state, meta = self.ckpt.restore(
                    {"params": params, "opt": opt_state})
                params, opt_state = state["params"], state["opt"]
                start = int(meta.get("next_step", latest + 1))

        t_prev = time.perf_counter()
        for step in range(start, self.cfg.total_steps):
            batch = self.dataset.next_batch(step)
            params, opt_state, metrics = self.step_fn(
                params, opt_state, batch, step)

            if (step + 1) % self.cfg.log_every == 0 or step == start:
                m = {k: float(v) for k, v in metrics.items()}
                now = time.perf_counter()
                m["step"] = step
                m["step_time_s"] = (now - t_prev) / max(
                    self.cfg.log_every if step != start else 1, 1)
                t_prev = now
                self.history.append(m)
                print(f"step {step:6d}  loss {m.get('loss', 0):8.4f}  "
                      f"grad_norm {m.get('grad_norm', 0):7.3f}  "
                      f"({m['step_time_s']*1e3:7.1f} ms/step)")

            if (self.ckpt is not None
                    and (step + 1) % self.cfg.checkpoint_every == 0):
                self.ckpt.save(step + 1,
                               {"params": params, "opt": opt_state},
                               metadata={"next_step": step + 1})

        if self.ckpt is not None:
            self.ckpt.save(self.cfg.total_steps,
                           {"params": params, "opt": opt_state},
                           metadata={"next_step": self.cfg.total_steps})
            self.ckpt.wait()
        return params, opt_state, self.history
