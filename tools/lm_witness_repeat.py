"""Repeat the float64 witness of ``chip_smoke.py``'s LM serving phase over
several token batches, to tell a fault of one run from an input that the
witness cannot hold.

    PYTHONPATH=src python tools/lm_witness_repeat.py [--random 4]

Needs a card. It serves ``chip_smoke.py``'s 4 requests (qwen2-0.5b at full
width, f32, the phase's seeds) to get the phase's token batch and its
near-ties; then, at the witness's depth of 2 layers, it runs the card in
float64 twice and the CPU in float64 at 8 threads and at 1, over that batch,
over the batch with each near-tie's token replaced by its runner-up, and
over ``--random`` batches of random tokens of the same shape. Prints one JSON
line a batch (the card against the CPU, where their largest difference
lies, the card against its own second run, the CPU's 8 threads against its
1, the card's f32 against its f64, the largest logit) and the batches over
the witness's bound.
"""

from __future__ import annotations

import argparse
import json
import sys
from dataclasses import replace
from pathlib import Path

import numpy as np
import torch

ROOT = Path(__file__).resolve().parents[1]
sys.path.insert(0, str(ROOT))
sys.path.insert(0, str(ROOT / "src"))

import chip_smoke as cs  # noqa: E402
from repro_torch.configs import get_config  # noqa: E402
from repro_torch.models import build_model  # noqa: E402
from repro_torch.train import make_serve_step  # noqa: E402


def served_batch(cfg, dev) -> tuple[torch.Tensor, list, int]:
    """The token batch of the serving phase's step a, and its near-ties as
    (request, served index, top-2 gap, top-1 token, top-2 token)."""
    model = build_model(cfg, device=dev, generator=torch.Generator().manual_seed(cs.LM_SEED))
    B, P, G = 4, 32, 32
    prompt = torch.randint(0, cfg.vocab, (B, P), generator=torch.Generator().manual_seed(cs.LM_SEED + 1)).to(dev)
    serve_step = make_serve_step(model)
    cache = model.init_cache(B, P + G)
    cache["pos"] = torch.zeros((), dtype=torch.int32, device=dev)
    fed, served = [], []
    for t in range(P + G):
        tok = prompt[:, t : t + 1] if t < P else served[-1]
        fed.append(tok)
        nxt, cache = serve_step(tok, cache)
        if t >= P - 1:
            served.append(nxt)
    seq = torch.cat(fed, dim=1)
    top2 = model.logits({"tokens": seq})[:, P - 1 :].topk(2, dim=-1)
    gap = top2.values[..., 0] - top2.values[..., 1]
    ties = [(int(b), int(t), float(gap[b, t]), int(top2.indices[b, t, 0]), int(top2.indices[b, t, 1]))
            for b, t in zip(*torch.nonzero(gap < cs.LM_CONSISTENCY["atol"], as_tuple=True))]
    return seq.cpu(), ties, P


@torch.no_grad()
def main(argv: list[str] | None = None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("--random", type=int, default=4, help="batches of random tokens")
    args = ap.parse_args(argv)
    if not torch.cuda.is_available():
        print("lm_witness_repeat: no CUDA device is available", file=sys.stderr)
        return 2
    cs.set_numerics()
    dev = torch.device("cuda")
    cfg = get_config(cs.LM_ARCH)
    print(f"card: {cs.card_line()}; torch {torch.__version__}", flush=True)

    seq, ties, P = served_batch(cfg, dev)
    torch.cuda.empty_cache()
    print(f"near-ties (request, served index, gap, top-1, top-2): {ties}", flush=True)
    batches = {"served": seq}
    for i, (b, t, _gap, t1, t2) in enumerate(ties):
        pos = P + t  # where the served token was fed back
        if pos < seq.shape[1]:
            alt = seq.clone()
            alt[b, pos] = t2 if int(seq[b, pos]) == t1 else t1
            batches[f"tie{i}_runner_up"] = alt
    g = torch.Generator().manual_seed(cs.LM_SEED + 7)
    for i in range(args.random):
        batches[f"random{i}"] = torch.randint(0, cfg.vocab, tuple(seq.shape), generator=g)

    cut = replace(cfg, n_layers=2)
    card32 = build_model(cut, device=dev, generator=torch.Generator(device=dev).manual_seed(cs.LM_SEED))
    state = card32.state_dict()
    card64 = build_model(cut, device=dev, dtype=torch.float64)
    card64.load_state_dict(state)
    cpu64 = build_model(cut, device="cpu", dtype=torch.float64)
    cpu64.load_state_dict(state)
    over = []
    for name, tokens in batches.items():
        card = card64.logits({"tokens": tokens.to(dev)}).cpu()
        card_again = card64.logits({"tokens": tokens.to(dev)}).cpu()
        torch.set_num_threads(8)
        cpu8 = cpu64.logits({"tokens": tokens})
        torch.set_num_threads(1)
        cpu1 = cpu64.logits({"tokens": tokens})
        torch.set_num_threads(cs.LM_CPU_THREADS)
        f32 = card32.logits({"tokens": tokens.to(dev)}).cpu()
        diff = (card - cpu8).abs()
        row = dict(batch=name, card_vs_cpu=float(diff.max()),
                   at=[int(i) for i in np.unravel_index(int(diff.argmax()), tuple(diff.shape))],
                   card_vs_card_again=cs.max_err(card, card_again), cpu8_vs_cpu1=cs.max_err(cpu8, cpu1),
                   card_f32_vs_f64=cs.max_err(f32, card), max_abs_logit=float(cpu8.abs().max()))
        print(json.dumps(row), flush=True)
        if row["card_vs_cpu"] > cs.F64_REL * row["max_abs_logit"]:
            over.append(name)
    print(f"over the witness's bound ({cs.F64_REL:g} x max|logits|): {over}")
    return 1 if over else 0


if __name__ == "__main__":
    sys.exit(main())
