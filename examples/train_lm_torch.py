"""End-to-end training driver on the PyTorch port: the twin of
``examples/train_lm.py``.

Trains a reduced LM for a few hundred steps through the port's stack —
model zoo, AdamW with fp32 masters, microbatch gradient accumulation, the
diffusion-balanced synthetic data pipeline — and prints the original's
lines. The weights are drawn from ``torch.Generator().manual_seed(0)``
(the original draws from ``jax.random.PRNGKey(0)``), so the losses are
the same process from another draw.

The device defaults to the card, and the run raises without one; pass
``--device cpu`` to train on the host.

    PYTHONPATH=src python examples/train_lm_torch.py [--steps 200] [--arch olmo-1b]
    PYTHONPATH=src python examples/train_lm_torch.py --device cpu --steps 41
"""

import argparse
import time

import torch

from repro_torch.configs import get_config
from repro_torch.models.zoo import DistContext, build_model
from repro_torch.train import (
    AdamWConfig,
    SyntheticTokenPipeline,
    adamw_init,
    make_train_step,
)


def main() -> None:
    ap = argparse.ArgumentParser()
    ap.add_argument("--arch", default="olmo-1b")
    ap.add_argument("--steps", type=int, default=200)
    ap.add_argument("--batch", type=int, default=16)
    ap.add_argument("--seq", type=int, default=64)
    ap.add_argument("--microbatches", type=int, default=2)
    ap.add_argument("--device", default=None, help="cpu, or a card (default: the card, raising without one)")
    args = ap.parse_args()

    cfg = get_config(args.arch).reduced()
    model = build_model(cfg, DistContext(remat=False), device=args.device,
                        generator=torch.Generator().manual_seed(0))
    dev = model.embed.device
    opt = adamw_init(model)
    n_params = sum(p.numel() for p in model.parameters())
    print(f"arch={args.arch} (reduced) params={n_params:,}")

    step = make_train_step(model, AdamWConfig(lr=3e-3, warmup_steps=20), microbatches=args.microbatches)
    pipe = SyntheticTokenPipeline(
        vocab=cfg.vocab, seq_len=args.seq, global_batch=args.batch, nranks=4
    )
    print(f"data buckets balanced onto 4 ranks in {pipe.balance_iters} diffusion "
          f"iterations; per-rank token loads {pipe.rank_load()}")

    t0 = time.perf_counter()
    tokens_seen = 0
    for i, batch in enumerate(pipe.structured_batches(args.steps)):
        b = {k: torch.from_numpy(v).to(dev) for k, v in batch.items()}
        opt, m = step(opt, b)
        tokens_seen += args.batch * args.seq
        if i % 20 == 0 or i == args.steps - 1:
            dt = time.perf_counter() - t0
            print(
                f"step {i:4d} loss={float(m['loss']):7.4f} "
                f"gnorm={float(m['grad_norm']):6.2f} "
                f"tok/s={tokens_seen / dt:9.0f}"
            )
    print("final loss:", float(m["loss"]))


if __name__ == "__main__":
    main()
