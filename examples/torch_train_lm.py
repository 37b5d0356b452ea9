"""End-to-end training example of the port: a qwen-family LM on the
synthetic packed-document pipeline, with checkpointing
(``examples/train_lm.py``).

    PYTHONPATH=src python examples/torch_train_lm.py [--steps 300]
        [--d-model 256] [--device cpu]

The port's ``Trainer`` takes a device where the reference's takes a mesh
(``make_host_mesh(1, 1)``).  Runs on the card unless ``--device cpu``;
checkpoints go to ``--ckpt`` (default ``build/train_lm`` in the
checkout, which git ignores).
"""

import argparse
import os
from dataclasses import replace

from repro_torch.configs import get_config
from repro_torch.configs.base import ShapeConfig
from repro_torch.distributed.optimizer import AdamWConfig
from repro_torch.kernels.common import resolve_device
from repro_torch.train import Trainer, TrainerConfig

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))


def main(argv=None) -> list:
    ap = argparse.ArgumentParser()
    ap.add_argument("--steps", type=int, default=200)
    ap.add_argument("--d-model", type=int, default=128)
    ap.add_argument("--layers", type=int, default=4)
    ap.add_argument("--seq-len", type=int, default=128)
    ap.add_argument("--batch", type=int, default=4)
    ap.add_argument("--vocab", type=int, default=32000)
    ap.add_argument("--hundred-m", action="store_true",
                    help="the full ~100M preset")
    ap.add_argument("--ckpt", default=os.path.join(ROOT, "build",
                                                   "train_lm"))
    ap.add_argument("--device", default=None,
                    help="default: the card; 'cpu' runs the plain path")
    args = ap.parse_args(argv)
    dev = resolve_device(args.device)
    if args.hundred_m:
        args.d_model, args.layers, args.vocab = 512, 12, 50257

    cfg = replace(get_config("qwen3-0.6b"),
                  name=f"qwen3-{args.d_model}d{args.layers}L",
                  num_layers=args.layers,
                  d_model=args.d_model,
                  num_heads=8, num_kv_heads=4, head_dim=32,
                  d_ff=4 * args.d_model,
                  vocab_size=args.vocab, max_seq_len=args.seq_len)
    n = cfg.param_count()
    print(f"model: {cfg.name} ({n/1e6:.1f}M params)")

    shape = ShapeConfig("train", args.seq_len, args.batch, "train")
    trainer = Trainer(
        cfg, shape,
        TrainerConfig(total_steps=args.steps, checkpoint_every=100,
                      checkpoint_dir=args.ckpt, log_every=20),
        AdamWConfig(lr=1e-3, warmup_steps=30, total_steps=args.steps),
        device=dev)
    trainer.run()
    losses = [l for _, l in trainer.history]
    print(f"loss: first={losses[0]:.3f} best={min(losses):.3f} "
          f"final={losses[-1]:.3f}")
    assert losses[-1] < losses[0], "training must reduce loss"
    print("train_lm OK")
    return losses


if __name__ == "__main__":
    main()
