"""Train a model for a few hundred steps with checkpoint/restart, on the
PyTorch port alone. The twin of ``train_small.py``: the same flags,
defaults and printed lines, plus ``--device`` (CUDA by default; without
CUDA it raises unless ``--device cpu`` is asked for). It imports nothing of
JAX or of the JAX package. The reduced config's heads are widened from 16
to 64, the smallest head dim the attention kernels take, so the same model
trains on the CPU and on the card.

Default is a fast CPU-sized run; ``--full`` trains the ~100M-parameter
configuration (slow on CPU — intended shape demonstration).

    PYTHONPATH=src python examples/train_small_torch.py
        [--arch internlm2-1.8b] [--steps 200] [--full] [--device cuda|cpu]
"""
import argparse
import dataclasses
import os
import tempfile

from repro_torch.configs import get_config
from repro_torch.kernels.flash_attention import HEAD_DIMS
from repro_torch.models import transformer as T
from repro_torch.training.train_loop import TrainConfig, train


def main(argv=None):
    ap = argparse.ArgumentParser()
    ap.add_argument("--arch", default="internlm2-1.8b")
    ap.add_argument("--steps", type=int, default=200)
    ap.add_argument("--full", action="store_true",
                    help="~100M params instead of the reduced config")
    ap.add_argument("--ckpt-dir", default=os.path.join(
        tempfile.gettempdir(), "repro_train_ckpt"))
    ap.add_argument("--device", default="cuda",
                    help="cuda (raises without it) or cpu")
    args = ap.parse_args(argv)
    dev = T.resolve_device(args.device)

    cfg = get_config(args.arch).reduced()
    cfg = dataclasses.replace(
        cfg, head_dim=min(d for d in HEAD_DIMS if d >= cfg.head_dim))
    if args.full:
        cfg = dataclasses.replace(
            cfg, d_model=512, n_heads=8, n_kv_heads=4, head_dim=64,
            d_ff=2048, vocab_size=32_000,
            name=cfg.name + "-100m")
    print(f"training {cfg.name}: {cfg.param_count()/1e6:.1f}M params, "
          f"{args.steps} steps")
    out = train(cfg, TrainConfig(
        steps=args.steps, global_batch=8, seq_len=64,
        ckpt_dir=args.ckpt_dir, ckpt_every=50, log_every=20), device=dev)
    print(f"loss {out['losses'][0]:.4f} -> {out['losses'][-1]:.4f} "
          f"(resumed_from={out['resumed_from']})")


if __name__ == "__main__":
    main()
