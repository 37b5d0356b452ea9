"""Training launcher.

    PYTHONPATH=src python -m repro_torch.launch.train --arch gpt2 \
        [--smoke] [--layers N] [--fused] [--steps 50] [--seq-len 128] \
        [--batch 8] [--lr 3e-4] [--ckpt DIR] [--ckpt-every 25] [--resume] \
        [--device cpu]

Trains on the card unless ``--device`` names another (``cpu`` runs the
kernels' plain versions).  ``--fused`` selects the kernel plan (the
config's ``use_fused_kernels``; the registry's configs run the eager
plan, as the reference's launcher does).  ``--smoke`` uses the reduced
config;
``--layers`` cuts the depth (llama3-8b at full width fits one card at 4
layers: float32 weights, gradients and two AdamW moments take 16 bytes a
parameter).  Checkpoints are the reference's format, so ``--resume``
continues a run of ``python -m repro.launch.train`` too.  The reference's
``--data``/``--model`` mesh flags come with the distributed slice.
"""

from __future__ import annotations

import argparse
import dataclasses
import sys

from ..configs import ARCHS, get_config
from ..configs.base import ShapeConfig
from ..distributed.optimizer import AdamWConfig
from ..train.trainer import Trainer, TrainerConfig


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("--arch", choices=sorted(ARCHS), required=True)
    ap.add_argument("--smoke", action="store_true",
                    help="reduced config (CPU-sized)")
    ap.add_argument("--layers", type=int, default=0,
                    help="cut the depth to N layers (0: the config's)")
    ap.add_argument("--fused", action="store_true",
                    help="the kernel plan (default: the config's plan)")
    ap.add_argument("--steps", type=int, default=50)
    ap.add_argument("--seq-len", type=int, default=128)
    ap.add_argument("--batch", type=int, default=8)
    ap.add_argument("--lr", type=float, default=3e-4)
    ap.add_argument("--ckpt", default="checkpoints")
    ap.add_argument("--ckpt-every", type=int, default=25)
    ap.add_argument("--resume", action="store_true")
    ap.add_argument("--device", default=None,
                    help="torch device (default: the CUDA card)")
    args = ap.parse_args(argv)

    cfg = get_config(args.arch)
    if args.smoke:
        cfg = cfg.reduced()
    if args.layers:
        cfg = dataclasses.replace(cfg, num_layers=args.layers)
    if args.fused:
        cfg = dataclasses.replace(cfg, use_fused_kernels=True)
    if cfg.quant != "none":
        ap.error(f"quant {cfg.quant!r}: quantized training (the "
                 "straight-through _w8_ste, layers.py:233) is not ported "
                 "yet")
    shape = ShapeConfig("cli", args.seq_len, args.batch, "train")
    tcfg = TrainerConfig(total_steps=args.steps,
                         checkpoint_every=args.ckpt_every,
                         checkpoint_dir=args.ckpt, log_every=5)
    opt = AdamWConfig(lr=args.lr, warmup_steps=max(1, args.steps // 10),
                      total_steps=args.steps)
    trainer = Trainer(cfg, shape, tcfg, opt, device=args.device)
    if args.resume and trainer.resume():
        print(f"[train] resumed at step {trainer.step}")
    metrics = trainer.run()
    first = trainer.history[0][1] if trainer.history else float("nan")
    print(f"[train] done: loss {first:.4f} -> "
          f"{metrics.get('loss', float('nan')):.4f} "
          f"in {trainer.step} steps")
    return 0


if __name__ == "__main__":
    sys.exit(main())
