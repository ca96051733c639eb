"""Smoke run of the PyTorch/CUDA port on one GPU: build, check, measure.

    python3 chip_smoke.py

Runs from the root of a checkout (it puts ``src/`` on the path), needs one
CUDA card, and imports nothing of jax or of the JAX package. Phases, one
finding per line:

1. card and build: ``nvidia-smi`` name and power limit; ``nvcc`` builds the
   stencil and ghost-fill kernels from
   ``src/repro_torch/kernels/lbm_collide/csrc``; ``-Xptxas -v`` lines and,
   for every instantiation (f32/f64 x D3Q19/D3Q27 x BGK/TRT stencils, solo,
   over a slot list, over members, through a halo map and through a halo
   map over members; copy/fine/values fills), registers, local (spill)
   bytes, shared memory and theoretical occupancy. The f32 D3Q19 TRT stencil must keep at least
   50 % occupancy, and no instantiation may spill to local memory.
2. main paths, the "full cavity": ``AMRLBM(LidDrivenCavityConfig(...)).run``
   on the hand-written kernels, D3Q19 TRT f32, 32^3 cells a block (34^3
   with the ghost layer), 4^3 roots, up to level 2, 4 ranks, 12 coarse
   steps with AMR every 4, in ``fused`` mode (each level with a ghost fill
   one launch of the stencil's halo route, which reads every ghost value
   from its source in the substep's pre-step buffers), in ``arena``
   mode (the stencil kernel), in ``fused_sharded`` mode (per rank: the
   emit gathers, then the halo route over the interior slot list, reading
   local rows, then over the boundary slot list, reading the received
   payloads' rows too, each list in neighbour order) and in
   ``device_sharded`` mode (4 ranks that share the card,
   ``rank_devices=("cuda:0",) * 4``: stacks padded to one height a level,
   per ppermute round each sender's emit and one on-device copy of its
   padded payload, then every rank's halo route over its whole padded
   stacks, a full-length slot list in neighbour order). Launch
   counts are zeroed just before each run and read just after. Prints
   blocks per level (and per rank), peak device memory, coarse steps/s,
   MLUPS, mass drift and the device modes' steady-state transfers (must be
   0/0). ``fused_sharded`` and ``device_sharded`` must grow the forest
   ``fused`` grows at every AMR event and end with every block's interior
   bitwise equal to ``fused``'s; ``device_sharded``'s ``DeviceComm`` bytes
   and messages per substep must equal ``fused_sharded``'s ``Comm``
   numbers, and every rank's device must hold the same bytes.
   ``torch.profiler`` breakdowns of 2 steady coarse steps: ``fused`` must
   hold no index gather, no ``cat``, no fill launch and one halo-route
   launch per filled active level a substep; ``fused_sharded`` no scatter,
   the fill launches by
   kind its programs count, the slot-list stencil, and its ``Comm`` bytes
   and messages per substep; ``device_sharded`` no scatter and the fill
   launches its superstep counts, with its launches by kind (stencils,
   fills by kind, emit gathers, payload copies), the padding's share of the
   stencil work and, beside ``fused_sharded``'s, its host operators. Then the fused
   superstep's rebuild after an AMR event, timed piece by piece. Then the
   tracers: ``fused_sharded`` with 256 tracers a root block (16,384), 8
   coarse steps with AMR every 4; count and ids must be conserved; prints
   the particles stage's seconds and the host<->device bytes of each tracer
   step.
2b. serving, at the full cavity's width: four ``arena`` jobs on the kernels
   (the physics of ``tests/test_serving.py``'s members; the fourth's lid
   lowered until it does not refine at the first AMR event) submitted to
   one ``SimulationService``, 8 coarse steps each with AMR every 4. Launch
   counts are zeroed just before the service and read just after. The
   batch must form one ensemble, split at an AMR event, build at most one
   program per (topology, level set) key, launch every stencil through the
   kernel's member axis (the halo route where a level has a fill) and no
   fill, and end with every member's forest
   and block interiors bitwise those of a solo ``fused`` run of its config.
   Then, from the state after the first event, the batch's groups against
   the four solo runs: program builds, first steps with their uploads, two
   steady coarse steps each (member coarse steps/s, MLUPS), the launches
   of one batched coarse step (must equal one solo fused step's, there
   and with all four members on the roots), and profiles of both. Then elastic resize
   at the cross-check's depth: ``fused_sharded`` resized 4 -> 2 at step 4,
   in memory and through a disk checkpoint, ends step 8 bitwise equal to an
   uninterrupted ``fused`` run; so must ``device_sharded`` resized 4 -> 2.
2c. analysis and telemetry, at the full cavity's width. Launch counts are
   zeroed just before and read just after. (a) ``fused``,
   ``fused_sharded`` and ``device_sharded`` (4 ranks on ``cuda:0``) each
   run the canonical build scenario (advance 2, one executed
   ``adapt(force_rebalance=True)``, advance 2) under
   ``RetraceSentinel``: the ``build:*`` counts by name must stay within the
   budgets of ``repro_torch.analysis.config``, and a warm ``advance(2)``
   must build nothing. (b) The protocol verifier on the plans the
   ``fused`` and ``fused_sharded`` runs of phase 2 held after each of
   their 3 AMR events (each pattern's ghost plan, each pattern's rank
   plan), with the engines' own slot maps: zero findings, seconds printed.
   (c) The ``fused_sharded`` run of (a) is traced: its Chrome trace must
   pass ``tools/trace_report.py``'s ``check_trace`` with all four substep
   phases and an ``amr.event``, its ``stage`` spans must sum exactly to
   ``data_stats``, its AMR report's stages must equal their spans, and no
   ring may evict. (d) Steady ``fused_sharded`` coarse steps/s with
   telemetry on and off, 8 alternating turns of 32 coarse steps; the
   quartiles of each mode, the ratio of the medians, and whether the
   interquartile ranges separate (else the ratio is unresolved).
   (e) ``examples/trace_fused_sharded_torch.py``'s ``main`` on the card
   into a temporary file: a valid trace. Prints the phase's wall time.
3. ``[lm]``, the LM scaffold's serving path at full width: qwen2-0.5b
   (24 layers, d_model 896, GQA 14/2, vocab 151,936, tied embeddings) from
   one seeded generator, through ``build_model``, ``Model.logits``,
   ``Model.decode`` and ``make_serve_step``; no kernel of the port runs
   here (the LM scaffold reaches no Pallas kernel). f32: 4 requests of 32
   prompt tokens served one token at a time, then 32 greedy tokens; decode
   logits within 2e-3 of the teacher-forced logits at every step, served
   tokens equal to the teacher-forced argmax except at counted near-ties.
   The float64 witness at 2 layers and full width: the card against the
   CPU, both in float64, within 1e-9 of the largest logit, and the card's
   f32 against its own f64 within ``LM_F32_VS_F64`` (no f32 result of the
   host's CPU is compared). bf16: prefill at B = 1, S = 8192 and decode at
   B = 32 against a full 32,768-slot cache, timed against the
   ``repro_torch.launch.perf_model`` bounds, with peak memory, a profile of
   2 decode steps (idle share, device operations) and one step under sync
   debug mode ``error``. TF32 stays off for f32 matmuls and cuDNN.
3b. ``[lm-families]``: granite-moe-1b-a400m, rwkv6-3b, zamba2-2.7b and
   whisper-small at full width from one seed, each through the same entry
   points: (a) f32 at full depth, 4 requests of 96 prompt and 64 greedy
   tokens, decode logits against ``Model.logits`` at every step (in f32
   at 2e-3; rwkv6 against the f64 prefill on the card at
   ``LM_DECODE_VS_F64``), served tokens against the teacher-forced argmax;
   (b, c) the float64 witness at a cut depth (2 layers, zamba2 6 with one
   shared-attention site, whisper 2 + 2 encoder layers) over 2 x 160
   tokens; (d) bf16 prefill at B = 1, S = 8192 (whisper 448 tokens over
   1500 frames) and decode (granite-moe B = 8, zamba2 B = 4 against 32,768
   slots; rwkv6 B = 32, state only; whisper B = 32 against its 448
   positions), timed against ``perf_model`` with peak memory, a profile of
   2 steps and one step under sync debug mode ``error``. moe runs a to c
   at capacity factor 4, where nothing drops, and leaves out each request
   from its first flipped route on (at most ``LM_ROUTE_FLIPS_MAX``). The
   phase sets its own numerics and passes alone (``--only lm-families``)
   as after the others; it prints an ``lm_families`` JSON line.
4. ``[lm-train]``, the LM training path (``adamw_init``,
   ``make_train_step``, ``save_train_state`` / ``load_train_state``,
   ``SyntheticTokenPipeline``): (a) the gradient witness at each phase 3 /
   3b arch's cut depth and full width over 2 x 160 tokens, ``Model.loss``
   and every gradient of the card in float64 against the CPU in float64
   (within 1e-9 of each leaf's max|g|) and of the card's f32 against its
   f64 (``LM_TRAIN_F32_VS_F64``); (b) remat on against off, gradients
   bitwise, and one step of 2 microbatches against 1 within
   ``tests/test_train.py``'s tolerances (but for moe, whose balance loss
   depends on the split); (c) a checkpoint of qwen2-0.5b at
   full width (2 layers, bf16 with f32 masters) restored bitwise, and the
   next step from it bitwise the live one's; (d) qwen2-0.5b at full width
   and depth learning 30 structured batches of 16 x 256, its loss falling
   by more than ``LM_TRAIN_LEARN_MARGIN``; (e) its bf16 train step at
   train_4k's length, global batch 8 in 2 microbatches, remat: ms a step,
   tokens/s against ``perf_model``'s bound, the optimizer update alone,
   peak memory, a profile of one step and one step under sync debug mode
   ``error``. It passes alone (``--only lm-train``) and prints an
   ``lm_train`` JSON line.
5. ``[lm-dist]``, the LM distribution layer (``repro_torch.sharding.specs``,
   ``repro_torch.launch``, the active ``DistContext``,
   ``sharded_decode_attention``) on an NCCL process group of one rank and a
   (1, 1) ("data", "model") mesh: (a) qwen2-0.5b at full width and depth in
   bf16, parameters placed by ``param_pspecs``, an active context against
   the inactive model on prefill logits (B = 1, S = 512) and 8 greedy decode
   steps (B = 8, T = 4096); (b) the one-rank flash-decode at qwen2-0.5b's
   decode width (B = 32, T = 32,768, bf16 cache) against ``decode_attention``
   in float64 within 1e-12, its f32 against its f64, both timed; (c) the dry
   run's ``decode_32k`` cell at B = 32: its per-rank argument bytes equal to
   the storage of the same tensors made on the card and to the allocator's
   growth in 512-byte blocks, and the decode FLOPs counted on the card equal
   to those counted on meta. It passes alone (``--only lm-dist``) and prints
   an ``lm_dist`` JSON line.
6. each kernel against its plain PyTorch version on the card, at the shapes
   the main path gives it (real state and a real compiled fill of the full
   cavity): the stencil at B = 64; the level-2 fill from its sources plus
   the stencil, that fill split by destination class (x face, y row, z
   face, edge or corner) and segment kind with each sub-table timed alone
   beside a ``Tensor.copy_`` of its value bytes, and the stencil's halo
   route on the same level (bitwise the fill then the stencil), and every
   filled level's route against its fill then stencil (a level with fine
   rows also through its fine segment alone and its other segments alone);
   the padded-slab form once; the stencil over a real rank's
   boundary slot list (bitwise the whole-stack kernel's blocks); that
   rank's level-2 halves and unsplit level through the halo route over
   the programs' neighbour-ordered lists, each bitwise the same work as
   fills then stencil and the route in block order, all three
   timed in turn, with the whole octets each list's launch groups hold
   and the payload rows each CTA's map tile names; the
   ``values`` fill of a real rank message segment (bitwise the plain
   scatter; kernel, plain version and ``Tensor.index_put_`` each timed as
   the median of 50 single launches, taken in turn); the member stencil
   over M = 4 states of the level-2 stack, the level-2 fill for 4 members
   (each bitwise M solo launches), and the member halo route (bitwise M
   solo halo launches and the member fill then the member stencil). Then
   small D3Q27 / BGK / f64 / odd-extent cases for the
   stencil and every fill segment kind (``same``, ``coarse``, ``fine``) in
   f32/f64 x D3Q19/D3Q27. Max error, kernel time, plain time and the bound.
7. cross-check at a smaller depth: ``restack``, ``arena``, ``fused``,
   ``sharded``, ``fused_sharded`` and ``device_sharded`` on the kernels and
   ``fused``, ``fused_sharded`` and ``device_sharded`` on the plain
   versions grow the same forest and agree on the interior fields
   (``device_sharded`` bitwise ``fused`` on each backend); with two or more
   cards ``device_sharded`` runs again with its ranks spread over them;
   ``restack`` and ``fused_sharded`` with 24 tracers a block under the lid
   agree on every tracer's position within 1e-10.
8. the card line, the ``lm_serve``, ``lm_families``, ``lm_train``,
   ``lm_dist`` and ``kernels`` JSON lines, the script's wall time and the
   final ``ok`` line.

``python3 chip_smoke.py --only lm,lm-families,lm-train,lm-dist`` runs just the
named LM phases, in that order, and ends with their JSON lines and the
``ok`` line. The serving phases build no autograd graph.
``python3 chip_smoke.py --only cavity`` runs phases 1, 2 to 2c and 6 and
ends with the card line, the ``kernels`` line and the ``ok`` line (no LM
phase, no phase 7).

Any failed check raises, so the script exits non-zero and prints no result.
"""

from __future__ import annotations

import gc
import importlib.util
import json
import math
import os
import re
import subprocess
import sys
import tempfile
import time
from collections import Counter
from pathlib import Path

import numpy as np
import torch

ROOT = Path(__file__).resolve().parent
sys.path.insert(0, str(ROOT / "src"))

HBM_BYTES_PER_S = 3.35e12  # H100 SXM HBM3, NVIDIA data sheet
SPACER_CYCLES = 500_000  # about 0.3 ms of sleep kernel at the H100's clock: covers one call's host time
FP32_FLOPS_PER_S = 67e12  # H100 SXM fp32 outside the tensor cores
TOL = {torch.float32: dict(rtol=3e-5, atol=3e-6), torch.float64: dict(rtol=1e-11, atol=1e-12)}
PHYSICS = dict(omega=1.5, u_lid=(0.08, 0.0, 0.0), refine_upper=0.03, refine_lower=0.004)
FULL_CAVITY = dict(
    cells_per_block=(32, 32, 32),
    ghost=1,
    root_grid=(4, 4, 4),
    max_level=2,
    nranks=4,
    balancer="diffusion-pushpull",
    collision="trt",
    **PHYSICS,
)
CROSS_CHECK = dict(cells_per_block=(32, 32, 32), root_grid=(2, 2, 2), max_level=1, nranks=4, **PHYSICS)
# device_sharded's ranks share one card, so that the script needs one card
SHARED_CARD = ("cuda:0",) * 4
# the serving phase's four members: the physics of tests/test_serving.py's
# MEMBERS on the full cavity (the fourth's lid is lowered, if it must be,
# until it does not refine at the first AMR event, so the batch splits)
SERVING_MEMBERS = [
    dict(omega=1.5, u_lid=(0.08, 0.0, 0.0)),
    dict(omega=1.7, u_lid=(0.06, 0.0, 0.0)),
    dict(omega=1.6, u_lid=(0.08, 0.02, 0.0)),
    dict(omega=1.9, u_lid=(0.05, 0.0, 0.0)),
]
SERVING_STEPS = 8
SERVING_AMR_INTERVAL = 4
# the full cavity's tracers: 256 a root block, the non-quick size of the
# JAX package's particles benchmark; the cross-check's, as its particle legs
TRACERS_FULL = dict(per_block=256, seed=0, alpha=0.05, boundary="reflect")
TRACERS_CROSS = dict(per_block=24, seed=1, alpha=0.05, region=((0.0, 0.0, 1.7), (2.0, 2.0, 2.0)))
KERNEL1_REPLACES = "src/repro/kernels/lbm_collide/lbm_collide.py:212"
KERNEL2_REPLACES = "src/repro/kernels/lbm_collide/lbm_collide.py:248"
KERNEL_SOURCE = "src/repro_torch/kernels/lbm_collide/csrc/lbm_collide.cu"
BF16_FLOPS_PER_S = 989e12  # H100 SXM dense bf16 on the tensor cores
# the LM serving phase: qwen2-0.5b at full width from one seed
LM_ARCH = "qwen2-0.5b"
LM_SEED = 0
LM_CONSISTENCY = dict(rtol=2e-3, atol=2e-3)  # tests/test_models_smoke.py's prefill/decode consistency
LM_PREFILL = dict(B=1, S=8192)  # prefill_32k's shape, cut from 32 x 32,768 to fit one card
LM_DECODE = dict(B=32, T=32768, steps=32, warmup=3)  # decode_32k's cache length, batch cut from 128
# the float64 witness: the card against the CPU, both in float64, at a cut
# depth and full width. Their sums differ only in order, about 1e-13 of the
# logits' scale, so this bound holds on any host by orders of magnitude
F64_REL = 1e-9
# the CPU threads of the float64 witness (its result does not depend on them
# beyond F64_REL)
LM_CPU_THREADS = min(8, os.cpu_count() or 1)
# the card's f32 against the card's f64, same weights, the witness's depth:
# each bound is 4x or more the largest error measured on an H100 (PERF.md,
# section 6, PR 19)
LM_F32_VS_F64 = {"qwen2-0.5b": 3e-5, "granite-moe-1b-a400m": 5e-5, "rwkv6-3b": 1.5e-4, "zamba2-2.7b": 4e-4,
                 "whisper-small": 4e-5}
# phase 3b: the moe, ssm, hybrid and audio families at full width from one
# seed. ``cut``: the witness's depth (whisper cuts its encoder alike);
# decode batch and cache length (rwkv6 carries state only; whisper's cache
# stops at its 448 positions); prefill length (whisper: 448 tokens over
# 1500 frames)
LM_FAMILIES = {
    "granite-moe-1b-a400m": dict(cut=2, decode_B=8, decode_T=32768, prefill_S=8192),
    "rwkv6-3b": dict(cut=2, decode_B=32, decode_T=None, prefill_S=8192),
    "zamba2-2.7b": dict(cut=6, decode_B=4, decode_T=32768, prefill_S=8192),
    "whisper-small": dict(cut=2, decode_B=32, decode_T=448, prefill_S=448),
}
LM_FAMILY_SEED = 0
LM_FAMILY_REQUESTS = dict(B=4, prompt=96, generated=64)
LM_FAMILY_DECODE = dict(steps=16, warmup=3)
# f32 decode against prefill: LM_CONSISTENCY against the f32 prefill, except
# for a family whose measured error there exceeded half of it; that family
# is held to the f64 prefill on the card at 4x or more its largest measured
# error (PERF.md, section 6, PR 19)
LM_DECODE_VS_F64 = {"rwkv6-3b": 3e-3}
# routes (the top-k expert sets) that differ between two runs at a router
# near-tie: the request is compared only up to the first such token, and at
# most this many tokens a family may flip over checks a to c
LM_ROUTE_FLIPS_MAX = 4
# phase 4: the LM training path. The gradient witness runs at phase 3's
# depth for qwen2-0.5b and phase 3b's for the others, over 2 x 160 tokens
# (across rwkv6's 64-token and mamba2's 128-token scan chunks)
LM_TRAIN_WITNESS = {LM_ARCH: 2, **{arch: spec["cut"] for arch, spec in LM_FAMILIES.items()}}
LM_TRAIN_WITNESS_BATCH = dict(B=2, S=160)
# the card's f32 gradients against its f64 ones, the largest per-leaf error
# relative to the leaf's max|g|: each bound 4x or more the largest measured
# on an H100 (PERF.md, section 6: 5.655e-06, 3.103e-06, 1.888e-05,
# 4.157e-05 and 4.607e-06)
LM_TRAIN_F32_VS_F64 = {"qwen2-0.5b": 3e-5, "granite-moe-1b-a400m": 2e-5, "rwkv6-3b": 8e-5, "zamba2-2.7b": 2e-4,
                       "whisper-small": 2e-5}
# remat on against off: the same operations, recomputed
LM_TRAIN_REMAT_BOUND = 0.0
# d. learning at full width and depth: structured batches (token t+1 =
# token t + 1) over the first ``data_vocab`` ids of the vocabulary, short
# enough that the steps see each id many times
LM_TRAIN_LEARN = dict(B=16, S=256, steps=30, data_vocab=2048, lr=1e-3, warmup=5)
# the loss must fall by more than this: at most a quarter of the smallest
# drop measured on an H100 (PERF.md, section 6: 6.1325)
LM_TRAIN_LEARN_MARGIN = 1.5
# e. timing at train_4k's sequence length, its global batch of 256 cut to 8
LM_TRAIN_TIMING = dict(B=8, S=4096, microbatches=2, steps=2)
# phase 5: the LM distribution layer on a one-rank NCCL mesh. a: qwen2-0.5b
# at full width and depth, bf16, with an active DistContext against the
# same weights with an inactive one: prefill logits at B x S, then greedy
# decode steps at B x T (each step's token the inactive model's argmax)
LM_DIST = dict(prefill_B=1, prefill_S=512, decode_B=8, decode_T=4096, steps=8)
# the active context's logits against the inactive one's: 0 is bitwise
LM_DIST_ACTIVE_BOUND = 0.0
# b. sharded_decode_attention at qwen2-0.5b's decode width over the group
LM_DIST_FLASH = dict(B=32, T=32768)
# the card's f32 flash-decode (bf16 cache) against its f64 one: 4x or more
# the largest error measured on an H100 80GB HBM3 at 700 W (7.433e-08; PERF.md, section 6)
LM_DIST_FLASH_F32_VS_F64 = 3e-7
# c. the dry run's decode_32k cell at a batch of 32 on the (1, 1) mesh
LM_DIST_DRYRUN_B = 32


def check(cond: bool, what: str) -> None:
    if not cond:
        raise RuntimeError(f"check failed: {what}")


def say(*parts) -> None:
    print(*parts, flush=True)


def card_line() -> str:
    out = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
        capture_output=True, text=True, check=True, timeout=60,
    )
    return out.stdout.strip().splitlines()[0]


def time_ms(fn, iters: int, warmup: int = 2) -> float:
    """Mean device time of one call, by CUDA events around ``iters`` calls."""
    for _ in range(warmup):
        fn()
    torch.cuda.synchronize()
    start = torch.cuda.Event(enable_timing=True)
    end = torch.cuda.Event(enable_timing=True)
    start.record()
    for _ in range(iters):
        fn()
    end.record()
    end.synchronize()
    return start.elapsed_time(end) / iters


def median_ms(fns: dict, n: int) -> dict:
    """Device time of one call of each of ``fns``, by CUDA events around
    each single call, the calls taken in turn ``n`` times: (median,
    quartiles) per name. A sleep kernel ahead of each start event keeps the
    card busy while the host records the event and enqueues the call, so
    the events bracket the call's device time and not the host's launch
    overhead."""
    for fn in fns.values():
        fn()
        fn()
    torch.cuda.synchronize()
    times = {k: [] for k in fns}
    for _ in range(n):
        for k, fn in fns.items():
            start = torch.cuda.Event(enable_timing=True)
            end = torch.cuda.Event(enable_timing=True)
            torch.cuda._sleep(SPACER_CYCLES)
            start.record()
            fn()
            end.record()
            end.synchronize()
            times[k].append(start.elapsed_time(end))
    return {k: (float(np.median(v)), float(np.percentile(v, 25)), float(np.percentile(v, 75))) for k, v in times.items()}


def flops_per_fluid_cell(Q: int, collision: str) -> int:
    """Floating-point operations the stencil does per fluid cell, counted
    from the kernel source: moments 7Q-1 (sum, three FMA chains), velocity
    and |u|^2 9, equilibrium 15 per direction, collision 12 (TRT) or 3 (BGK)
    per direction. Non-fluid cells only copy."""
    return 7 * Q - 1 + 9 + Q * (15 + (12 if collision == "trt" else 3))


def stencil_bound_ms(f: torch.Tensor, mask: torch.Tensor, collision: str, extra_bytes: int = 0):
    """Least time for the stencil on these inputs: the larger of its bytes
    (read f and mask once, write f once, plus ``extra_bytes``) over HBM
    bandwidth and its fp32 operations on this mask's fluid cells over the
    fp32 peak."""
    B, Q = f.shape[:2]
    nbytes = 2 * f.numel() * f.element_size() + mask.numel() * mask.element_size() + extra_bytes
    fluid = int((mask == 0).sum())
    t_bytes = nbytes / HBM_BYTES_PER_S * 1e3
    t_ops = fluid * flops_per_fluid_cell(Q, collision) / FP32_FLOPS_PER_S * 1e3
    return (t_bytes, "bytes") if t_bytes >= t_ops else (t_ops, "operations")


def fill_traffic(tables, cells: int) -> dict:
    """What a from-sources fill must move, each item once: its ghost rows
    (Q values written each), the distinct source cells it reads (Q values
    each: a coarse cell that feeds several fine ghost rows, or a cell that
    two rows share, counts once) and its int32 index bytes. Source
    cells are split by whether they lie in the destination's own buffer
    (``same`` rows) or in another level's."""
    rows = sum(t.dst_slot.numel() for t in tables)
    index_bytes = sum(a.numel() * a.element_size() for t in tables
                      for a in (t.dst_slot, t.dst_cell, t.src_slot, t.src_cell))
    keys = {}
    for t in tables:
        slot = t.src_slot.cpu().numpy().astype(np.int64)
        cell = t.src_cell.cpu().numpy()
        if cell.ndim == 2:
            slot = np.repeat(slot, cell.shape[1])
        keys.setdefault(t.kind == "same", []).append(slot * cells + cell.ravel())
    # kinds read different source levels, so distinct (level, slot, cell)
    # triples are distinct keys within each group
    src = {own: int(np.unique(np.concatenate(k)).size) for own, k in keys.items()}
    return dict(rows=rows, index_bytes=index_bytes, src_own=src.get(True, 0), src_other=src.get(False, 0),
                rows_by_kind={t.kind: t.dst_slot.numel() for t in tables})


def route_traffic(local_tables, msg_tables, listed, own: int, cells: int) -> dict:
    """What a rank route over the ``listed`` blocks of its level must move
    beside the stencil of those blocks, each item once: the ghost rows of
    the listed blocks (whose values in the level's own buffer it need not
    read), the distinct source cells of their local rows outside the listed
    blocks (``own`` is the level's position among the sources), the distinct
    payload rows they name, and their int32 index bytes."""
    keep = torch.zeros(int(max(listed)) + 1 if len(listed) else 1, dtype=torch.bool)
    keep[torch.as_tensor(np.asarray(listed, np.int64))] = True
    rows = index_bytes = 0
    src_keys, payload_keys = [], []
    for t in (*local_tables, *msg_tables):
        ds = t.dst_slot.cpu().long()
        sel = (ds < keep.numel()) & keep[ds.clamp(max=keep.numel() - 1)]
        n = int(sel.sum())
        rows += n
        arrays = [a for a in (t.dst_slot, t.dst_cell, t.src_slot, t.src_cell) if a is not None]
        index_bytes += sum(n * (a[0].numel() if a.dim() == 2 else 1) * a.element_size() for a in arrays)
        cell = t.src_cell.cpu().numpy()[sel.numpy()].astype(np.int64)
        if t.kind == "values":
            payload_keys.append(t.src * (1 << 40) + cell)
            continue
        slot = t.src_slot.cpu().numpy()[sel.numpy()].astype(np.int64)
        if cell.ndim == 2:
            slot = np.repeat(slot, cell.shape[1])
        inside = (t.src == own) & np.isin(slot, np.asarray(listed))
        src_keys.append((t.src * (1 << 40) + slot * cells + cell.ravel())[~inside])
    distinct = lambda keys: int(np.unique(np.concatenate(keys)).size) if keys else 0  # noqa: E731
    return dict(rows=rows, src_outside=distinct(src_keys), payload_rows=distinct(payload_keys),
                index_bytes=index_bytes)


def stencil_tiles(Y: int, Z: int) -> tuple[int, int, int, int]:
    """The stencil's CTA shape (TZ, TY, tiles_z, tiles_y), as the source's
    ``StencilTiles`` computes it."""
    threads = 256
    tiles_z = -(-Z // threads)
    TZ = -(-Z // tiles_z)
    TY = min(threads // TZ, Y)
    tiles_y = -(-Y // TY)
    return TZ, -(-Y // tiles_y), tiles_z, tiles_y


def payload_tile_counts(cells: torch.Tensor, listed, payload_segs) -> np.ndarray:
    """The payload rows that each CTA's map tile names (3 x (TY + 2) x (TZ +
    2) wrapped cells) over the ``listed`` blocks of a halo map ``cells`` (B,
    X, Y, Z): one count a CTA, the entries whose segment is in
    ``payload_segs``."""
    _B, X, Y, Z = cells.shape
    TZ, TY, tiles_z, tiles_y = stencil_tiles(Y, Z)
    sel = torch.as_tensor(np.asarray(listed, np.int64), device=cells.device)
    c = cells[sel]
    segs = torch.as_tensor(sorted(payload_segs), dtype=torch.int64, device=cells.device)
    pay = ((c >= 0) & torch.isin(c >> 58, segs)).to(torch.int32)

    def wrapped(start: int, size: int, n: int) -> torch.Tensor:
        return torch.remainder(torch.arange(start, start + size, device=cells.device), n)

    counts = []
    for tz in range(tiles_z):
        cz = pay[..., wrapped(tz * TZ - 1, TZ + 2, Z)].sum(-1)  # (L, X, Y)
        for ty in range(tiles_y):
            cy = cz[..., wrapped(ty * TY - 1, TY + 2, Y)].sum(-1)  # (L, X)
            counts.append(cy[:, wrapped(-1, X, X)] + cy + cy[:, wrapped(1, X, X)])
    return torch.stack(counts).cpu().numpy().ravel()


def tile_histogram(counts: np.ndarray) -> dict:
    """CTAs by the payload rows their tile names, in bins of 64 rows (the
    empty tiles apart), with the largest count and the 99th percentile."""
    nz = counts[counts > 0]
    bins = Counter(int((c - 1) // 64) for c in nz)
    hist = {"0": int((counts == 0).sum())}
    hist.update({f"{64 * b + 1}-{64 * (b + 1)}": bins[b] for b in sorted(bins)})
    return dict(ctas=int(counts.size), hist=hist, max=int(counts.max(initial=0)),
                p99=float(np.percentile(counts, 99)) if counts.size else 0.0)


# a stencil instantiation's demangled name: its SLOTS, MEMBERS, HALO and
# PAYLOADS
STENCIL_NAME = re.compile(r"stream_collide_kernel<[^,>]+, *\d+, *(?:true|false), *(true|false), *(true|false), "
                          r"*(true|false), *(true|false)>")
FILL_CLASSES = ("x-face", "y-row", "z-face", "edge/corner")


def fill_classes(tables, dims) -> dict:
    """A level's fill tables split by the class of each row's ghost cell (on
    the x, y or z face alone, or on two or three faces: an edge or a
    corner) and by segment kind: ``{(class, kind): FillTable}``, rows in
    their sorted order."""
    import dataclasses

    X, Y, Z = dims
    out = {}
    for t in tables:
        x, rest = np.divmod(t.dst_cell.cpu().numpy(), Y * Z)
        y, z = np.divmod(rest, Z)
        on = ((x == 0) | (x == X - 1), (y == 0) | (y == Y - 1), (z == 0) | (z == Z - 1))
        n_on = on[0].astype(int) + on[1] + on[2]
        cls = np.where(n_on >= 2, 3, np.where(on[0], 0, np.where(on[1], 1, 2)))
        for c, name in enumerate(FILL_CLASSES):
            sel = torch.as_tensor(np.flatnonzero(cls == c), device=t.dst_slot.device)
            if sel.numel():
                out[name, t.kind] = dataclasses.replace(
                    t, **{k: getattr(t, k)[sel].contiguous() for k in ("dst_slot", "dst_cell", "src_slot", "src_cell")})
    return out


def max_err(a: torch.Tensor, b: torch.Tensor) -> float:
    """max |a - b| in float64, slice by slice along the first axis for a
    tensor of more than 2**27 elements (a member stack's float64 copies
    would take tens of GB)."""
    if a.dim() > 1 and a.numel() > 1 << 27:
        return max(max_err(x, y) for x, y in zip(a, b))
    return float((a.double() - b.double()).abs().max())


def device_profile(run, host_rows: list | None = None, attempts: int = 3,
                   events: bool = False) -> tuple[list | None, float, float]:
    """``torch.profiler`` over ``run()`` (which must end in a device
    synchronize): (kernel rows (name, device ms, count) by time, device
    busy ms, wall ms). With ``host_rows``, the host's operators (name, self
    CPU ms, count) by time are appended to it. A profile that recorded no
    device activity is taken again, up to ``attempts`` times in all (the
    profiler has been seen to drop a short run's kernels). If none records
    any, the script fails; with ``events``, ``run()`` is timed once more
    with CUDA events instead, and the result is (None, the events' device
    ms from the first launch to the last end, wall ms)."""
    for attempt in range(attempts):
        rows, busy, wall = _device_profile(run, host_rows)
        if busy > 0:
            return rows, busy, wall
        say(f"  (profile attempt {attempt + 1} recorded no device time; taken again)")
    check(events, f"the profiler recorded device time in one of {attempts} attempts")
    say(f"  (no device time in {attempts} profiles; timed with CUDA events instead)")
    start, end = torch.cuda.Event(enable_timing=True), torch.cuda.Event(enable_timing=True)
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    start.record()
    run()
    end.record()
    end.synchronize()
    return None, start.elapsed_time(end), (time.perf_counter() - t0) * 1e3


def aten_ops(run) -> Counter:
    """The PyTorch operators that ``run()`` dispatches, by name: a host-side
    view of what it asks the card to do, which needs no profiler."""
    from torch.utils._python_dispatch import TorchDispatchMode

    seen = Counter()

    class Record(TorchDispatchMode):
        def __torch_dispatch__(self, func, types, args=(), kwargs=None):
            seen[str(func)] += 1
            return func(*args, **(kwargs or {}))

    with Record():
        run()
    return seen


def _device_profile(run, host_rows: list | None = None) -> tuple[list, float, float]:
    from torch.autograd import DeviceType
    from torch.profiler import ProfilerActivity, profile

    torch.cuda.synchronize()
    with profile(activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA]) as prof:
        t0 = time.perf_counter()
        run()
        wall_ms = (time.perf_counter() - t0) * 1e3
    events = prof.key_averages()
    rows = sorted(
        ((e.key, e.self_device_time_total / 1e3, e.count) for e in events
         if e.device_type == DeviceType.CUDA and e.self_device_time_total > 0),
        key=lambda r: -r[1],
    )
    if host_rows is not None:
        host_rows += sorted(((e.key, e.self_cpu_time_total / 1e3, e.count) for e in events
                             if e.device_type == DeviceType.CPU and e.self_cpu_time_total > 0), key=lambda r: -r[1])
    return rows, sum(r[1] for r in rows), wall_ms


@torch.no_grad()
def lm_serving_phase() -> dict:
    """Phase 3: the LM scaffold's serving path at full width (qwen2-0.5b,
    weights from ``torch.Generator().manual_seed(LM_SEED)``). (a) f32
    self-consistency: 4 requests of 32 prompt tokens through ``serve_step``
    one token at a time from a 64-slot cache at ``pos = 0``, then 32
    greedy tokens fed back; ``Model.decode``'s logits at every one of the 64
    steps (a second pass over the same tokens) against ``Model.logits``
    over the 64 tokens, and the served tokens against the teacher-forced
    argmax (a mismatch is allowed only where the top-2 gap is under the
    tolerance: counted). (b) ``witness_checks`` at 2 layers over the same
    tokens: the card against the CPU in float64, and the card's f32 against
    its f64. (c) bf16 prefill timing, ``B x S =
    LM_PREFILL``. (d) bf16 decode timing, ``LM_DECODE``, every step reading
    the whole cache (``pos = cache_len``), a profile of 2 steps, and one step
    under ``torch.cuda.set_sync_debug_mode("error")``: no host sync."""
    from dataclasses import replace

    from repro_torch.configs import get_config
    from repro_torch.configs.shapes import ShapeConfig
    from repro_torch.launch.perf_model import hbm_bytes_estimate, model_flops
    from repro_torch.models import build_model
    from repro_torch.train import make_serve_step

    t_phase = time.perf_counter()
    set_numerics()
    card = card_line()
    cfg = get_config(LM_ARCH)
    dev = torch.device("cuda")

    # -- a. full width, f32, self-consistency ---------------------------------
    t0 = time.perf_counter()
    model = build_model(cfg, device=dev, generator=torch.Generator().manual_seed(LM_SEED))
    torch.cuda.synchronize()
    n_params = sum(p.numel() for p in model.parameters())
    say(f"[lm] {LM_ARCH}: {cfg.n_layers} layers, d_model {cfg.d_model}, {cfg.n_heads} heads over {cfg.n_kv} kv heads, "
        f"d_ff {cfg.d_ff}, vocab {cfg.vocab}; {n_params:,} parameters ({cfg.params_count():,} by "
        f"ArchConfig.params_count, which leaves out biases and norms), drawn in {time.perf_counter() - t0:.2f} s")
    B, P, G = 4, 32, 32
    prompt = torch.randint(0, cfg.vocab, (B, P), generator=torch.Generator().manual_seed(LM_SEED + 1)).to(dev)
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
    served = torch.cat(served, dim=1)  # the outputs at positions P-1 .. P+G-1
    full = model.logits({"tokens": seq})
    check(full.shape == (B, P + G, cfg.vocab) and bool(torch.isfinite(full).all()), "full-width logits finite")
    cache = model.init_cache(B, P + G)
    cache["pos"] = torch.zeros((), dtype=torch.int32, device=dev)
    err_steps = []
    for t in range(P + G):
        step_logits, cache = model.decode(seq[:, t : t + 1], cache)
        torch.testing.assert_close(step_logits[:, 0], full[:, t], **LM_CONSISTENCY)
        err_steps.append(max_err(step_logits[:, 0], full[:, t]))
    teacher = full[:, P - 1 :].argmax(dim=-1)
    top2 = full[:, P - 1 :].topk(2, dim=-1).values
    gap = top2[..., 0] - top2[..., 1]
    mismatch = served.long() != teacher
    near_ties = int((gap < LM_CONSISTENCY["atol"]).sum())
    check(bool((~mismatch | (gap < LM_CONSISTENCY["atol"])).all()),
          "served tokens equal the teacher-forced argmax except at near-ties")
    a = dict(requests=B, prompt=P, generated=G, decode_vs_logits_max_err_last_step=err_steps[-1],
             decode_vs_logits_max_err=max(err_steps), served_tokens=int(served.numel()),
             mismatches=int(mismatch.sum()), near_ties=near_ties)
    say(f"[lm] a. f32 self-consistency: decode logits vs Model.logits max |diff| {a['decode_vs_logits_max_err']:.3e} "
        f"over {P + G} steps (last step {err_steps[-1]:.3e}; tolerance 2e-3); served {a['served_tokens']} tokens, "
        f"{a['mismatches']} differ from the teacher-forced argmax, at {near_ties} near-ties (top-2 gap < 2e-3) "
        f"[{card}]")

    # -- b. the float64 witness, cut to 2 layers ---------------------------------
    del full
    b = witness_checks(replace(cfg, n_layers=2), {"tokens": seq.cpu()}, LM_SEED, "[lm] b")
    check(b["card_vs_cpu_f64"] <= b["f64_bound"],
          f"card f64 within {b['f64_bound']:.3e} of the CPU's f64 ({b['card_vs_cpu_f64']:.3e} at "
          f"{b['card_vs_cpu_f64_at']})")
    check(b["card_f32_vs_f64"] <= b["f32_bound"],
          f"card f32 within {b['f32_bound']:g} of the card's f64 ({b['card_f32_vs_f64']:.3e})")
    say(f"[lm] b. 2 layers at full width, card against CPU over {B}x{P + G} tokens, both float64: logits max "
        f"|diff| {b['card_vs_cpu_f64']:.3e} (bound {F64_REL:g} x max|logits| = {b['f64_bound']:.3e}); the card's "
        f"f32 against its f64: {b['card_f32_vs_f64']:.3e} (bound {b['f32_bound']:g}) [{card}]")
    set_numerics()

    # -- c. prefill timing, bf16 ------------------------------------------------
    model16 = build_model(cfg, device=dev, dtype=torch.bfloat16)
    model16.load_state_dict(model.state_dict())  # weights rounded to bf16, norms stay f32
    del model, cache
    Bp, Sp = LM_PREFILL["B"], LM_PREFILL["S"]
    tokens = torch.randint(0, cfg.vocab, (Bp, Sp), generator=torch.Generator().manual_seed(LM_SEED + 2)).to(dev)
    logits = model16.logits({"tokens": tokens})
    check(logits.shape == (Bp, Sp, cfg.vocab) and logits.dtype == torch.bfloat16
          and bool(torch.isfinite(logits).all()), "bf16 prefill logits finite")
    del logits
    # the peak of the timed calls alone: the finiteness check's temporaries
    # are larger than the logits
    torch.cuda.synchronize()
    mem0 = torch.cuda.memory_allocated()
    torch.cuda.reset_peak_memory_stats()
    prefill_ms = time_ms(lambda: model16.logits({"tokens": tokens}), iters=3, warmup=1)
    shape = ShapeConfig("prefill", Sp, Bp, "prefill")
    flops, nbytes = model_flops(cfg, shape), hbm_bytes_estimate(cfg, shape)
    t_ops, t_bytes = flops / BF16_FLOPS_PER_S * 1e3, nbytes / HBM_BYTES_PER_S * 1e3
    c = dict(B=Bp, S=Sp, ms=prefill_ms, tokens_per_s=Bp * Sp / prefill_ms * 1e3,
             peak_gb=(torch.cuda.max_memory_allocated() - mem0) / 1e9, model_flops=flops, hbm_bytes=nbytes,
             bound_ms=max(t_ops, t_bytes), bound_by="operations" if t_ops >= t_bytes else "bytes")
    say(f"[lm] c. bf16 prefill B={Bp} S={Sp}: {prefill_ms:.3f} ms ({c['tokens_per_s']:.1f} tokens/s), peak "
        f"{c['peak_gb']:.3f} GB above the weights; bound {c['bound_ms']:.3f} ms by {c['bound_by']} "
        f"({flops / 1e12:.3f} TFLOP at 989 TFLOP/s, {nbytes / 1e9:.3f} GB at 3.35 TB/s) [{card}]")

    # -- d. decode timing, bf16, against a full cache ---------------------------
    Bd, T = LM_DECODE["B"], LM_DECODE["T"]
    torch.cuda.synchronize()
    mem0 = torch.cuda.memory_allocated()
    torch.cuda.reset_peak_memory_stats()
    cache = model16.init_cache(Bd, T, torch.bfloat16)  # pos = cache_len: every step reads all T slots
    cache_bytes = sum(cache[k].numel() * cache[k].element_size() for k in ("k", "v"))
    serve16 = make_serve_step(model16)
    tok = torch.randint(0, cfg.vocab, (Bd, 1), generator=torch.Generator().manual_seed(LM_SEED + 3)).to(dev)
    tok = tok.to(torch.int32)
    for _ in range(LM_DECODE["warmup"]):
        tok, cache = serve16(tok, cache)
    torch.cuda.synchronize()
    torch.cuda.set_sync_debug_mode("error")
    try:
        tok, cache = serve16(tok, cache)
    finally:
        torch.cuda.set_sync_debug_mode("default")
    start, end = torch.cuda.Event(enable_timing=True), torch.cuda.Event(enable_timing=True)
    start.record()
    for _ in range(LM_DECODE["steps"]):
        tok, cache = serve16(tok, cache)
    end.record()
    end.synchronize()
    step_ms = start.elapsed_time(end) / LM_DECODE["steps"]
    check(tok.shape == (Bd, 1) and bool(((tok >= 0) & (tok < cfg.vocab)).all()), "decode tokens in the vocabulary")
    peak_gb = (torch.cuda.max_memory_allocated() - mem0) / 1e9

    def two_steps():
        nonlocal tok, cache
        for _ in range(2):
            tok, cache = serve16(tok, cache)
        torch.cuda.synchronize()

    rows, busy_ms, wall_ms = device_profile(two_steps)
    shape = ShapeConfig("decode", T, Bd, "decode")
    nbytes = hbm_bytes_estimate(cfg, shape)
    d = dict(B=Bd, T=T, steps=LM_DECODE["steps"], ms_per_step=step_ms, tokens_per_s=Bd / step_ms * 1e3,
             peak_gb=peak_gb, cache_gb=cache_bytes / 1e9, hbm_bytes=nbytes,
             bound_ms=nbytes / HBM_BYTES_PER_S * 1e3, bound_by="bytes", model_flops=model_flops(cfg, shape),
             profile_busy_ms=busy_ms, profile_wall_ms=wall_ms, idle_share=1.0 - busy_ms / wall_ms,
             launches_2_steps=sum(r[2] for r in rows), sync_free=True)
    say(f"[lm] d. bf16 decode B={Bd} against T={T} ({d['cache_gb']:.3f} GB of k/v): {step_ms:.3f} ms a step "
        f"({d['tokens_per_s']:.1f} tokens/s) over {LM_DECODE['steps']} steps, peak {peak_gb:.3f} GB above the "
        f"weights; bound {d['bound_ms']:.3f} ms ({nbytes / 1e9:.3f} GB at 3.35 TB/s); 2 steps: device busy "
        f"{busy_ms:.3f} of {wall_ms:.3f} ms wall, idle {d['idle_share']:.1%}, {d['launches_2_steps']} device "
        f"operations; one step ran under sync debug mode 'error' [{card}]")
    for name, ms, count in rows[:8]:
        say(f"[lm]   {ms:9.3f} ms {count:6d}x {name[:110]}")
    del model16, cache
    torch.cuda.empty_cache()
    out = dict(arch=LM_ARCH, card=card, params=n_params, consistency_f32=a, card_vs_cpu=b, prefill_bf16=c,
               decode_bf16=d, seconds=time.perf_counter() - t_phase)
    say(f"[lm] phase 3 wall time {out['seconds']:.2f} s")
    return out


def set_numerics() -> None:
    """The global numerics state the phases rely on, set at the script's
    start and again at each LM phase's (so that a phase passes alone or
    after any other): f32 products in full f32 (no TF32 in matmuls or
    cuDNN), float32 as the default dtype, ``LM_CPU_THREADS`` CPU threads.
    Each phase seeds its own generators."""
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    torch.set_float32_matmul_precision("highest")
    torch.set_default_dtype(torch.float32)
    torch.set_num_threads(LM_CPU_THREADS)


def record_routes(model, on: bool = True) -> None:
    """Start (``on``) or stop each moe layer's record of its expert ids. A
    layer that remat recomputes in the backward pass records again, so a
    record of a training forward takes a model with remat off."""
    for layer in model.layers:
        if hasattr(layer, "routes"):
            layer.routes = [] if on else None


def take_routes(model) -> list | None:
    """Each moe layer's expert ids since the last take, (B, S, K) with its
    calls joined along S; None for a model without moe layers."""
    out = []
    for layer in model.layers:
        if getattr(layer, "routes", None) is not None:
            out.append(torch.cat(layer.routes, dim=1))
            layer.routes = []
    return out or None


def first_flips(a: list | None, b: list | None, B: int, S: int) -> torch.Tensor:
    """Per request, the first position whose expert set differs between two
    runs' routes in any layer (S where none does). A flipped token reaches
    its request's later positions through attention, so a comparison keeps
    only the positions before it."""
    first = torch.full((B,), S, dtype=torch.long)
    for x, y in zip(a or [], b or []):
        differ = (x.cpu().sort(dim=-1).values != y.cpu().sort(dim=-1).values).any(dim=-1)
        first = torch.minimum(first, torch.where(differ, torch.arange(S), S).amin(dim=1))
    return first


def held_positions(first: torch.Tensor, S: int) -> torch.Tensor:
    """(B, S) mask of the positions before each request's first flip."""
    return torch.arange(S)[None, :] < first[:, None]


def masked_max_err(got: torch.Tensor, want: torch.Tensor, held: torch.Tensor) -> tuple[float, list]:
    """Largest |got - want| over the held (B, S) positions, and where."""
    diff = (got.double() - want.double()).abs().amax(dim=-1).cpu()
    diff = torch.where(held, diff, torch.zeros_like(diff))
    at = np.unravel_index(int(diff.argmax()), tuple(diff.shape))
    return float(diff.max()), [int(i) for i in at]


def witness_checks(cfg, batch: dict, seed: int, tag: str) -> dict:
    """Checks b and c of the LM phases at ``cfg``'s (cut) depth and full
    width, one seed's weights drawn on the card in f32. (b) The card in
    float64 against the CPU in float64 over ``batch``: within ``F64_REL``
    of the CPU's largest logit. (c) The card's f32 against the card's f64:
    within ``LM_F32_VS_F64[arch]``. No f32 result of the host's CPU is
    compared. Routes that flip are left out from their position on (counted)."""
    from repro_torch.models import build_model

    dev = torch.device("cuda")
    set_numerics()
    card32 = build_model(cfg, device=dev, generator=torch.Generator(device=dev).manual_seed(seed))
    state = card32.state_dict()
    card64 = build_model(cfg, device=dev, dtype=torch.float64)
    card64.load_state_dict(state)
    cpu64 = build_model(cfg, device="cpu", dtype=torch.float64)
    cpu64.load_state_dict(state)
    del state
    B, S = batch["tokens"].shape

    def run(model, dt) -> torch.Tensor:
        d = next(model.parameters()).device
        logits = model.logits({k: (v.to(d, dt) if v.is_floating_point() else v.to(d)) for k, v in batch.items()})
        if d.type == "cuda":
            torch.cuda.synchronize()
        return logits.cpu()

    out, routes = {}, {}
    for name, model, dt in (("card64", card64, torch.float64), ("cpu64", cpu64, torch.float64),
                            ("card32", card32, torch.float32)):
        record_routes(model)
        t0 = time.perf_counter()
        out[name] = run(model, dt)
        out[name + "_s"] = time.perf_counter() - t0
        routes[name] = take_routes(model)
        record_routes(model, on=False)
    check(all(bool(torch.isfinite(out[k]).all()) for k in ("card64", "cpu64", "card32")), f"{tag} finite logits")
    first_b = first_flips(routes["card64"], routes["cpu64"], B, S)
    first_c = first_flips(routes["card32"], routes["card64"], B, S)
    scale = float(out["cpu64"].abs().max())
    err_b, at_b = masked_max_err(out["card64"], out["cpu64"], held_positions(first_b, S))
    err_c, at_c = masked_max_err(out["card32"], out["card64"], held_positions(first_c, S))
    if err_b > F64_REL * scale:
        # the caller's check fails on these results; a second run of each
        # float64 side says which of them, if either, did not reproduce
        # itself
        again = {name: run(model, torch.float64) for name, model in (("card64", card64), ("cpu64", cpu64))}
        say(f"{tag}: card f64 against CPU f64 {err_b:.3e} at {at_b}, over {F64_REL:g} x max|logits| {scale:.3f}; "
            f"run again: card f64 against its first run {max_err(again['card64'], out['card64']):.3e}, CPU f64 "
            f"against its first run {max_err(again['cpu64'], out['cpu64']):.3e}, card against CPU "
            f"{max_err(again['card64'], again['cpu64']):.3e}")
    flips = int((first_b < S).sum()) + int((first_c < S).sum())
    res = dict(layers=cfg.n_layers, encoder_layers=cfg.encoder_layers, tokens=[B, S], max_abs_logit=scale,
               card_vs_cpu_f64=err_b, card_vs_cpu_f64_at=at_b, f64_bound=F64_REL * scale,
               card_f32_vs_f64=err_c, card_f32_vs_f64_at=at_c, f32_bound=LM_F32_VS_F64[cfg.arch_id],
               route_flips=flips, positions_left_out=int((S - first_b).sum() + (S - first_c).sum()),
               cpu64_seconds=out["cpu64_s"], cpu_threads=torch.get_num_threads())
    del card32, card64, cpu64
    torch.cuda.empty_cache()
    return res


@torch.no_grad()
def lm_families_phase() -> dict:
    """Phase 3b: the moe, ssm, hybrid and audio families at full width
    (``LM_FAMILIES``), weights from ``torch.Generator("cuda")`` seeded
    ``LM_FAMILY_SEED``, through ``build_model``, ``Model.logits``,
    ``Model.decode`` and ``make_serve_step``. Per family:
    (a) f32 on the card, full depth: ``LM_FAMILY_REQUESTS`` served one token
    at a time through ``serve_step`` from ``pos = 0``, then a second pass
    of ``Model.decode`` over the same tokens; its logits at every step
    against ``Model.logits`` in f32 (``LM_CONSISTENCY``) or, for the
    families of ``LM_DECODE_VS_F64``, against ``Model.logits`` of the same
    weights in f64 on the card; served tokens equal the teacher-forced
    argmax except at counted near-ties (top-2 gap under the bound).
    (b, c) ``witness_checks`` at the family's cut depth over 2 x 160 tokens.
    (d) bf16 prefill at B = 1 and decode at the family's batch against a
    full cache (whisper: its 448 positions; rwkv6: state only), timed
    against the ``repro_torch.launch.perf_model`` bounds, peak memory, a
    profile of 2 decode steps and one step under sync debug mode ``error``.
    moe runs a, b and c at capacity factor ``n_experts / top_k``, where no
    token drops (a prefill of 640 tokens drops at the config's 1.25; a
    decode step never does), and leaves out each request's positions from
    its first flipped route on, at most ``LM_ROUTE_FLIPS_MAX`` tokens. The
    phase sets its numerics (``set_numerics``) and runs alone as well as
    after the others. Every family runs to its end; a failed check fails
    the phase after the last."""
    from dataclasses import replace

    from repro_torch.configs import get_config
    from repro_torch.configs.shapes import ShapeConfig
    from repro_torch.launch.perf_model import hbm_bytes_estimate, model_flops
    from repro_torch.models import build_model
    from repro_torch.train import make_serve_step

    t_phase = time.perf_counter()
    set_numerics()
    card = card_line()
    dev = torch.device("cuda")
    failures: list[str] = []

    def soft(cond: bool, what: str) -> None:
        if not cond:
            failures.append(what)
            say(f"[lm-families] FAILED: {what}")

    results = {}
    for arch, spec in LM_FAMILIES.items():
        t_arch = time.perf_counter()
        cfg = get_config(arch)
        if cfg.family == "moe":
            cfg = replace(cfg, capacity_factor=cfg.n_experts / cfg.top_k)
        gen = lambda off=0: torch.Generator(device=dev).manual_seed(LM_FAMILY_SEED + off)  # noqa: E731

        def enc_embeds(n: int, g: torch.Generator, dtype=torch.float32):
            if not cfg.is_encoder_decoder:
                return {}
            e = 0.5 * torch.randn((n, cfg.encoder_len, cfg.d_model), generator=g, device=dev)
            return {"enc_embeds": e.to(dtype)}

        # -- a. full depth, f32, decode against prefill ----------------------
        set_numerics()
        t0 = time.perf_counter()
        model = build_model(cfg, device=dev, generator=gen())
        torch.cuda.synchronize()
        n_params = sum(p.numel() for p in model.parameters())
        enc_l = f" + {cfg.encoder_layers} encoder layers over {cfg.encoder_len} frames" if cfg.encoder_layers else ""
        say(f"[lm-families] {arch} ({cfg.family}): {cfg.n_layers} layers{enc_l}, d_model {cfg.d_model}, vocab "
            f"{cfg.vocab}; {n_params:,} parameters, drawn in {time.perf_counter() - t0:.2f} s [{card}]")
        B, P, G = LM_FAMILY_REQUESTS["B"], LM_FAMILY_REQUESTS["prompt"], LM_FAMILY_REQUESTS["generated"]
        S = P + G
        prompt = torch.randint(0, cfg.vocab, (B, P), generator=gen(1), device=dev)
        extras = enc_embeds(B, gen(2))

        def fresh_cache(m):
            c = m.init_cache(B, S)
            if "pos" in c:
                c["pos"] = torch.zeros((), dtype=torch.int32, device=dev)
            if extras:
                m.fill_cross_cache(c, extras["enc_embeds"])
            return c

        serve_step = make_serve_step(model)
        cache = fresh_cache(model)
        fed, served = [], []
        for t in range(S):
            tok = prompt[:, t : t + 1] if t < P else served[-1]
            fed.append(tok)
            nxt, cache = serve_step(tok, cache)
            if t >= P - 1:
                served.append(nxt)
        seq = torch.cat(fed, dim=1)
        served = torch.cat(served, dim=1)  # outputs at positions P-1 .. S-1
        record_routes(model)
        cache = fresh_cache(model)
        steps = []
        for t in range(S):
            step_logits, cache = model.decode(seq[:, t : t + 1], cache)
            steps.append(step_logits[:, 0])
        decoded = torch.stack(steps, dim=1)
        del steps, cache
        routes_decode = take_routes(model)
        full32 = model.logits({"tokens": seq, **extras})
        routes32 = take_routes(model)
        record_routes(model, on=False)
        check(full32.shape == (B, S, cfg.vocab) and bool(torch.isfinite(full32).all()), f"{arch} f32 logits finite")
        model64 = build_model(cfg, device=dev, dtype=torch.float64)
        model64.load_state_dict(model.state_dict())
        record_routes(model64)
        full64 = model64.logits({"tokens": seq, **{k: v.double() for k, v in extras.items()}})
        routes64 = take_routes(model64)
        del model64
        first = torch.minimum(first_flips(routes_decode, routes32, B, S), first_flips(routes_decode, routes64, B, S))
        held = held_positions(first, S)
        err32, at32 = masked_max_err(decoded, full32, held)
        err64, at64 = masked_max_err(decoded, full64, held)
        last32 = masked_max_err(decoded[:, -1:], full32[:, -1:], held[:, -1:])[0]
        against_f64 = arch in LM_DECODE_VS_F64
        bound_a = LM_DECODE_VS_F64[arch] if against_f64 else LM_CONSISTENCY["atol"]
        ref = full64 if against_f64 else full32
        err_a = err64 if against_f64 else err32
        soft(err_a <= bound_a, f"{arch} a. decode logits within {bound_a:g} of the "
                               f"{'f64' if against_f64 else 'f32'} prefill ({err_a:.3e})")
        tail = ref[:, P - 1 :]
        teacher = tail.argmax(dim=-1)
        top2 = tail.topk(2, dim=-1).values
        near = (top2[..., 0] - top2[..., 1]) < bound_a
        kept = held[:, P - 1 :].to(dev)
        mismatch = (served.long() != teacher) & kept
        soft(bool((~mismatch | near).all()), f"{arch} a. served tokens equal the teacher-forced argmax except at "
                                               f"near-ties ({int(mismatch.sum())} differ)")
        flips_a = int((first < S).sum())
        a = dict(requests=B, prompt=P, generated=G, reference="f64 prefill" if against_f64 else "f32 prefill",
                 bound=bound_a, decode_vs_f32_prefill=err32, decode_vs_f32_prefill_at=at32,
                 decode_vs_f32_prefill_last_step=last32, decode_vs_f64_prefill=err64, decode_vs_f64_prefill_at=at64,
                 served_tokens=int(served.numel()), mismatches=int(mismatch.sum()),
                 near_ties=int((near & kept).sum()), route_flips=flips_a,
                 positions_left_out=int((~held).sum()))
        cf = f"; capacity factor {cfg.capacity_factor:g}, {flips_a} routes flipped" if cfg.family == "moe" else ""
        say(f"[lm-families] {arch} a. f32 over {S} steps x {B} requests: decode logits vs Model.logits max |diff| "
            f"f32 {err32:.3e} at {at32} (last step {last32:.3e}), f64 {err64:.3e} at {at64}; held to the "
            f"{a['reference']} within {bound_a:g}; served {a['served_tokens']} tokens, {a['mismatches']} off the "
            f"teacher-forced argmax, {a['near_ties']} near-ties (top-2 gap < {bound_a:g}){cf} [{card}]")
        del full32, full64, decoded, model
        torch.cuda.empty_cache()

        # -- b, c. the float64 witness at a cut depth --------------------------
        cut = replace(cfg, n_layers=spec["cut"], encoder_layers=spec["cut"] if cfg.encoder_layers else 0)
        g = torch.Generator().manual_seed(LM_FAMILY_SEED + 3)
        wbatch = {"tokens": torch.randint(0, cfg.vocab, (2, 160), generator=g)}
        if cfg.is_encoder_decoder:
            wbatch["enc_embeds"] = 0.5 * torch.randn((2, cfg.encoder_len, cfg.d_model), generator=g)
        w = witness_checks(cut, wbatch, LM_FAMILY_SEED, f"{arch} b/c")
        soft(w["card_vs_cpu_f64"] <= w["f64_bound"], f"{arch} b. card f64 within {w['f64_bound']:.3e} of the "
                                                       f"CPU's f64 ({w['card_vs_cpu_f64']:.3e} at {w['card_vs_cpu_f64_at']})")
        soft(w["card_f32_vs_f64"] <= w["f32_bound"], f"{arch} c. card f32 within {w['f32_bound']:g} of the card's "
                                                       f"f64 ({w['card_f32_vs_f64']:.3e})")
        soft(a["route_flips"] + w["route_flips"] <= LM_ROUTE_FLIPS_MAX,
             f"{arch}: at most {LM_ROUTE_FLIPS_MAX} routes flip ({a['route_flips'] + w['route_flips']})")
        enc_c = f" + {cut.encoder_layers} encoder layers" if cut.encoder_layers else ""
        say(f"[lm-families] {arch} b. {cut.n_layers} layers{enc_c} at full width over 2x160 tokens, float64: card "
            f"against CPU logits max |diff| {w['card_vs_cpu_f64']:.3e} at {w['card_vs_cpu_f64_at']} (bound "
            f"{F64_REL:g} x max|logits| {w['max_abs_logit']:.3f} = {w['f64_bound']:.3e}; CPU {w['cpu_threads']} "
            f"threads, {w['cpu64_seconds']:.2f} s) [{card}]")
        say(f"[lm-families] {arch} c. the card's f32 against its f64, same weights: max |diff| "
            f"{w['card_f32_vs_f64']:.3e} at {w['card_f32_vs_f64_at']} (bound {w['f32_bound']:g}); "
            f"{w['route_flips']} routes flipped, {w['positions_left_out']} positions left out [{card}]")

        # -- d. bf16 timing -------------------------------------------------
        set_numerics()
        cfg16 = get_config(arch)  # the config's own capacity factor
        model16 = build_model(cfg16, device=dev, dtype=torch.bfloat16, generator=gen(4))
        Sp = spec["prefill_S"]
        pbatch = {"tokens": torch.randint(0, cfg.vocab, (1, Sp), generator=gen(5), device=dev),
                  **enc_embeds(1, gen(6), torch.bfloat16)}
        logits = model16.logits(pbatch)
        check(logits.shape == (1, Sp, cfg.vocab) and bool(torch.isfinite(logits).all()), f"{arch} bf16 prefill finite")
        del logits
        torch.cuda.synchronize()
        mem0 = torch.cuda.memory_allocated()
        torch.cuda.reset_peak_memory_stats()
        prefill_ms = time_ms(lambda: model16.logits(pbatch), iters=3, warmup=1)
        shape = ShapeConfig("prefill", Sp, 1, "prefill")
        flops, nbytes = model_flops(cfg16, shape), hbm_bytes_estimate(cfg16, shape)
        t_ops, t_bytes = flops / BF16_FLOPS_PER_S * 1e3, nbytes / HBM_BYTES_PER_S * 1e3
        c = dict(B=1, S=Sp, frames=cfg.encoder_len if cfg.is_encoder_decoder else None, ms=prefill_ms,
                 tokens_per_s=Sp / prefill_ms * 1e3, peak_gb=(torch.cuda.max_memory_allocated() - mem0) / 1e9,
                 model_flops=flops, hbm_bytes=nbytes, bound_ms=max(t_ops, t_bytes),
                 bound_by="operations" if t_ops >= t_bytes else "bytes")
        del pbatch
        frames = f" (+{cfg.encoder_len} frames)" if cfg.is_encoder_decoder else ""
        say(f"[lm-families] {arch} d. bf16 prefill B=1 S={Sp}{frames}: {prefill_ms:.3f} ms ({c['tokens_per_s']:.1f} "
            f"tokens/s), peak {c['peak_gb']:.3f} GB above the weights; bound {c['bound_ms']:.3f} ms by "
            f"{c['bound_by']} ({flops / 1e12:.3f} TFLOP at 989 TFLOP/s, {nbytes / 1e9:.3f} GB at 3.35 TB/s) [{card}]")

        Bd, T = spec["decode_B"], spec["decode_T"]
        torch.cuda.synchronize()
        mem0 = torch.cuda.memory_allocated()
        torch.cuda.reset_peak_memory_stats()
        cache = model16.init_cache(Bd, T or 1, torch.bfloat16)  # pos = cache_len: every step reads every slot
        if cfg.is_encoder_decoder:
            model16.fill_cross_cache(cache, enc_embeds(Bd, gen(7), torch.bfloat16)["enc_embeds"])
        state_bytes = 0
        for v in cache.values():
            for leaf in (v.values() if isinstance(v, dict) else [v]):
                state_bytes += leaf.numel() * leaf.element_size()
        serve16 = make_serve_step(model16)
        tok = torch.randint(0, cfg.vocab, (Bd, 1), generator=gen(8), device=dev).to(torch.int32)
        for _ in range(LM_FAMILY_DECODE["warmup"]):
            tok, cache = serve16(tok, cache)
        torch.cuda.synchronize()
        torch.cuda.set_sync_debug_mode("error")
        try:
            tok, cache = serve16(tok, cache)
        finally:
            torch.cuda.set_sync_debug_mode("default")
        start, end = torch.cuda.Event(enable_timing=True), torch.cuda.Event(enable_timing=True)
        start.record()
        for _ in range(LM_FAMILY_DECODE["steps"]):
            tok, cache = serve16(tok, cache)
        end.record()
        end.synchronize()
        step_ms = start.elapsed_time(end) / LM_FAMILY_DECODE["steps"]
        check(tok.shape == (Bd, 1) and bool(((tok >= 0) & (tok < cfg.vocab)).all()), f"{arch} decode tokens in range")
        peak_gb = (torch.cuda.max_memory_allocated() - mem0) / 1e9

        def two_steps():
            nonlocal tok, cache
            for _ in range(2):
                tok, cache = serve16(tok, cache)
            torch.cuda.synchronize()

        rows, busy_ms, wall_ms = device_profile(two_steps)
        # a state-only cache (rwkv6) is read and written whole each step:
        # perf_model's decode bytes read the cache once and write 1/T of it
        shape = ShapeConfig("decode", T or 1, Bd, "decode")
        nbytes = hbm_bytes_estimate(cfg16, shape)
        d = dict(B=Bd, T=T, steps=LM_FAMILY_DECODE["steps"], ms_per_step=step_ms, tokens_per_s=Bd / step_ms * 1e3,
                 peak_gb=peak_gb, state_gb=state_bytes / 1e9, hbm_bytes=nbytes,
                 bound_ms=nbytes / HBM_BYTES_PER_S * 1e3, bound_by="bytes", model_flops=model_flops(cfg16, shape),
                 profile_busy_ms=busy_ms, profile_wall_ms=wall_ms, idle_share=1.0 - busy_ms / wall_ms,
                 launches_2_steps=sum(r[2] for r in rows), sync_free=True,
                 top_ops=[[name[:120], ms, count] for name, ms, count in rows[:6]])
        against = f"against T={T}" if T else "state only"
        say(f"[lm-families] {arch} d. bf16 decode B={Bd} {against} ({d['state_gb']:.3f} GB of cache and state): "
            f"{step_ms:.3f} ms a step ({d['tokens_per_s']:.1f} tokens/s) over {d['steps']} steps, peak "
            f"{peak_gb:.3f} GB above the weights; bound {d['bound_ms']:.3f} ms ({nbytes / 1e9:.3f} GB at 3.35 TB/s); "
            f"2 steps: device busy {busy_ms:.3f} of {wall_ms:.3f} ms wall, idle {d['idle_share']:.1%}, "
            f"{d['launches_2_steps']} device operations; one step ran under sync debug mode 'error' [{card}]")
        for name, ms, count in rows[:6]:
            say(f"[lm-families]   {ms:9.3f} ms {count:6d}x {name[:110]}")
        del model16, cache
        torch.cuda.empty_cache()
        results[arch] = dict(family=cfg.family, source=cfg.source, params=n_params, consistency_f32=a,
                             witness=w, prefill_bf16=c, decode_bf16=d, seconds=time.perf_counter() - t_arch)
        say(f"[lm-families] {arch} wall time {results[arch]['seconds']:.2f} s [{card}]")
    out = dict(card=card, archs=results, failures=failures, seconds=time.perf_counter() - t_phase)
    say(f"[lm-families] phase 3b wall time {out['seconds']:.2f} s [{card}]")
    check(not failures, f"phase 3b: {failures}")
    return out


def grad_leaf_err(got: dict, want: dict) -> tuple[float, str]:
    """The largest per-leaf ``max|got - want| / max|want|`` over two
    parameter-name -> gradient maps (CPU tensors, ``None`` for a leaf
    outside the loss), and its leaf. Both sides must leave out the same
    leaves, and a leaf whose ``want`` is all zero must be all zero."""
    check(got.keys() == want.keys(), "the same parameters")
    worst, at = 0.0, ""
    for name, w in want.items():
        g = got[name]
        check((g is None) == (w is None), f"{name}: a gradient on both sides or on neither")
        if w is None:
            continue
        scale = float(w.abs().max())
        diff = float((g.double() - w.double()).abs().max())
        err = diff / scale if scale > 0 else (0.0 if diff == 0 else float("inf"))
        if err > worst or not at:
            worst, at = err, name
    return worst, at


def grad_witness(cfg, batch: dict, seed: int, tag: str):
    """Phase 4a at ``cfg``'s (cut) depth and full width, one seed's weights
    drawn on the card in f32 (as ``witness_checks``): ``Model.loss`` and
    every gradient of the card in float64 against the CPU in float64
    (within ``F64_REL`` of each leaf's max|g|), and of the card's f32
    against the card's f64 (within ``LM_TRAIN_F32_VS_F64[arch]``). No f32
    result of the host's CPU is compared. The models run with remat off, so
    that each moe layer records its routes once a forward (a layer
    recomputed in the backward pass would record again); every route must
    agree. Returns the result, the card's f32 model and its gradients."""
    from repro_torch.models import build_model
    from repro_torch.models.zoo import DistContext

    dev = torch.device("cuda")
    set_numerics()
    plain = DistContext(remat=False)
    card32 = build_model(cfg, plain, device=dev, generator=torch.Generator(device=dev).manual_seed(seed))
    state = card32.state_dict()
    card64 = build_model(cfg, plain, device=dev, dtype=torch.float64)
    card64.load_state_dict(state)
    cpu64 = build_model(cfg, plain, device="cpu", dtype=torch.float64)
    cpu64.load_state_dict(state)
    del state
    B, S = batch["tokens"].shape
    grads, losses, routes, secs = {}, {}, {}, {}
    for name, model, dt in (("card64", card64, torch.float64), ("cpu64", cpu64, torch.float64),
                            ("card32", card32, torch.float32)):
        d = next(model.parameters()).device
        record_routes(model)
        t0 = time.perf_counter()
        loss, _ = model.loss({k: (v.to(d, dt) if v.is_floating_point() else v.to(d)) for k, v in batch.items()})
        loss.backward()
        if d.type == "cuda":
            torch.cuda.synchronize()
        secs[name] = time.perf_counter() - t0
        losses[name] = float(loss.detach())
        grads[name] = {n: (p.grad.detach().cpu() if p.grad is not None else None) for n, p in model.named_parameters()}
        for p in model.parameters():
            p.grad = None
        routes[name] = take_routes(model)
        record_routes(model, on=False)
    check(all(math.isfinite(v) for v in losses.values()), f"{tag} finite losses")
    check(all(g is None or bool(torch.isfinite(g).all()) for gs in grads.values() for g in gs.values()),
          f"{tag} finite gradients")
    flips = int((first_flips(routes["card64"], routes["cpu64"], B, S) < S).sum()
                + (first_flips(routes["card32"], routes["card64"], B, S) < S).sum())
    err_b, at_b = grad_leaf_err(grads["card64"], grads["cpu64"])
    err_c, at_c = grad_leaf_err(grads["card32"], grads["card64"])
    res = dict(layers=cfg.n_layers, encoder_layers=cfg.encoder_layers, tokens=[B, S], loss_f64=losses["cpu64"],
               loss_card_vs_cpu_f64=abs(losses["card64"] - losses["cpu64"]),
               loss_card_f32_vs_f64=abs(losses["card32"] - losses["card64"]),
               grad_card_vs_cpu_f64=err_b, grad_card_vs_cpu_f64_at=at_b, f64_bound=F64_REL,
               grad_card_f32_vs_f64=err_c, grad_card_f32_vs_f64_at=at_c, f32_bound=LM_TRAIN_F32_VS_F64[cfg.arch_id],
               leaves=len(grads["cpu64"]), leaves_outside_the_loss=sum(g is None for g in grads["cpu64"].values()),
               route_flips=flips, cpu64_seconds=secs["cpu64"], cpu_threads=torch.get_num_threads())
    del card64, cpu64
    torch.cuda.empty_cache()
    return res, card32, grads["card32"]


@torch.no_grad()
def clone_state(x):
    """A copy of an optimizer state (or any nest of dicts of tensors)."""
    return {k: clone_state(v) for k, v in x.items()} if isinstance(x, dict) else x.clone()


def states_bitwise(a: dict, b: dict) -> bool:
    return a.keys() == b.keys() and all(
        states_bitwise(a[k], b[k]) if isinstance(a[k], dict) else torch.equal(a[k], b[k]) for k in a)


def lm_train_phase() -> dict:
    """Phase 4: the LM training path through ``build_model``,
    ``adamw_init``, ``make_train_step``, ``save_train_state`` /
    ``load_train_state`` and ``SyntheticTokenPipeline``. (a) The gradient
    witness (``grad_witness``) for qwen2-0.5b and the four archs of phase
    3b at their witness depths (``LM_TRAIN_WITNESS``) and full width, over
    ``LM_TRAIN_WITNESS_BATCH`` tokens from phase 3b's witness generator and
    their next tokens as labels. (b) On the card's f32 models of (a):
    ``remat=True`` against ``remat=False``, gradients bitwise; one step of
    ``microbatches=2`` against 1 from the same state, loss within 2e-3 and
    parameters within rtol 2e-2 / atol 2e-4 (``tests/test_train.py``'s
    microbatch tolerances), except for the moe arch, whose balance loss
    depends on the split (printed, not held). (c) qwen2-0.5b at the witness depth and full
    width, bf16 parameters and f32 masters, 2 steps, then a checkpoint
    saved and loaded into a zero model and a fresh state: every leaf
    bitwise, and one step from the restored state bitwise one step from the
    live state. (d) qwen2-0.5b at full width and depth, bf16 parameters, f32
    masters, ``remat=True``: ``LM_TRAIN_LEARN`` structured batches, every
    loss and grad norm finite and the loss falling by more than
    ``LM_TRAIN_LEARN_MARGIN``. (e) The same model at ``train_4k``'s length
    (``LM_TRAIN_TIMING``): ms a step and tokens/s against ``perf_model``'s
    bound for that cut shape, the optimizer update's ms alone, peak memory,
    a profile of one step and one step under sync debug mode ``error``.
    The phase sets its numerics and runs alone (``--only lm-train``) as well
    as after the others."""
    from dataclasses import replace

    from repro_torch.configs import get_config
    from repro_torch.configs.shapes import ShapeConfig
    from repro_torch.launch.perf_model import hbm_bytes_estimate, model_flops
    from repro_torch.models import build_model
    from repro_torch.models.zoo import DistContext
    from repro_torch.train import AdamWConfig, SyntheticTokenPipeline, adamw_init, adamw_update, make_train_step
    from repro_torch.train.checkpoint import load_train_state, save_train_state

    t_phase = time.perf_counter()
    set_numerics()
    card = card_line()
    dev = torch.device("cuda")
    out: dict = dict(card=card)
    failures: list[str] = []

    def soft(cond: bool, what: str) -> None:
        if not cond:
            failures.append(what)
            say(f"[lm-train] FAILED: {what}")

    def on_card(b: dict) -> dict:
        return {k: torch.from_numpy(v).to(dev) for k, v in b.items()}

    # -- a, b. the gradient witness; remat and microbatches ---------------------
    out["witness"], out["remat_microbatches"] = {}, {}
    for arch, cut in LM_TRAIN_WITNESS.items():
        t_arch = time.perf_counter()
        cfg = get_config(arch)
        if cfg.family == "moe":  # as phase 3b: no token drops
            cfg = replace(cfg, capacity_factor=cfg.n_experts / cfg.top_k)
        cfg = replace(cfg, n_layers=cut, encoder_layers=cut if cfg.encoder_layers else 0)
        g = torch.Generator().manual_seed(LM_FAMILY_SEED + 3)
        B, S = LM_TRAIN_WITNESS_BATCH["B"], LM_TRAIN_WITNESS_BATCH["S"]
        tokens = torch.randint(0, cfg.vocab, (B, S + 1), generator=g)
        batch = {"tokens": tokens[:, :-1], "labels": tokens[:, 1:]}
        if cfg.is_encoder_decoder:
            batch["enc_embeds"] = 0.5 * torch.randn((B, cfg.encoder_len, cfg.d_model), generator=g)
        w, model, grads = grad_witness(cfg, batch, LM_FAMILY_SEED, f"[lm-train] {arch} a")
        soft(w["route_flips"] == 0, f"{arch} a. every moe route agrees ({w['route_flips']} flipped)")
        soft(w["loss_card_vs_cpu_f64"] <= F64_REL * abs(w["loss_f64"]),
              f"{arch} a. card f64 loss within {F64_REL:g} of the CPU's ({w['loss_card_vs_cpu_f64']:.3e})")
        soft(w["grad_card_vs_cpu_f64"] <= F64_REL, f"{arch} a. card f64 gradients within {F64_REL:g} x max|g| of "
                                                   f"the CPU's ({w['grad_card_vs_cpu_f64']:.3e} at {w['grad_card_vs_cpu_f64_at']})")
        soft(w["grad_card_f32_vs_f64"] <= w["f32_bound"],
              f"{arch} a. card f32 gradients within {w['f32_bound']:g} x max|g| of its f64 "
              f"({w['grad_card_f32_vs_f64']:.3e} at {w['grad_card_f32_vs_f64_at']})")
        enc_c = f" + {cfg.encoder_layers} encoder layers" if cfg.encoder_layers else ""
        say(f"[lm-train] {arch} a. {cut} layers{enc_c} at full width over {B}x{S} tokens: loss {w['loss_f64']:.6f}; "
            f"float64 card against CPU: loss |diff| {w['loss_card_vs_cpu_f64']:.3e}, gradients {w['grad_card_vs_cpu_f64']:.3e} "
            f"of max|g| at {w['grad_card_vs_cpu_f64_at']} (bound {F64_REL:g}; CPU {w['cpu_threads']} threads, "
            f"{w['cpu64_seconds']:.2f} s); the card's f32 against its f64: loss |diff| {w['loss_card_f32_vs_f64']:.3e}, "
            f"gradients {w['grad_card_f32_vs_f64']:.3e} of max|g| at {w['grad_card_f32_vs_f64_at']} (bound "
            f"{w['f32_bound']:g}); {w['leaves']} leaves, {w['leaves_outside_the_loss']} outside the loss, "
            f"{w['route_flips']} routes flipped [{card}]")
        out["witness"][arch] = w

        # b. remat against no remat, and 2 microbatches against 1
        batch = {k: v.to(dev) for k, v in batch.items()}
        model.dist = DistContext(remat=True)
        loss, _ = model.loss(batch)
        loss.backward()
        soft(all((p.grad is None) == (grads[n] is None) for n, p in model.named_parameters()),
             f"{arch} b. remat leaves out the same leaves")
        remat_err = max(max_err(p.grad, grads[n].to(dev)) for n, p in model.named_parameters() if p.grad is not None)
        model.zero_grad(set_to_none=True)
        soft(remat_err <= LM_TRAIN_REMAT_BOUND, f"{arch} b. remat gradients within {LM_TRAIN_REMAT_BOUND:g} of "
                                                 f"the plain ones ({remat_err:.3e})")
        state = clone_state(model.state_dict())
        opt0 = adamw_init(model)
        steps, losses_b = {}, {}
        for mb in (1, 2):
            model.load_state_dict(state)
            _, m = make_train_step(model, AdamWConfig(lr=1e-3), microbatches=mb)(clone_state(opt0), batch)
            losses_b[mb] = float(m["loss"])
            steps[mb] = clone_state(model.state_dict())
        mb_loss = abs(losses_b[1] - losses_b[2])
        mb_ok = all(torch.allclose(steps[2][k], steps[1][k], rtol=2e-2, atol=2e-4) for k in steps[1])
        mb_err = max(max_err(steps[2][k], steps[1][k]) for k in steps[1])
        # the moe's Switch balance loss is a product of per-batch routing
        # fractions, so a split batch has another loss: held for the others
        held = cfg.family != "moe"
        soft(not held or (mb_loss < 2e-3 and mb_ok),
             f"{arch} b. 2 microbatches against 1: loss |diff| {mb_loss:.3e} < 2e-3, parameters within rtol 2e-2 / "
             f"atol 2e-4 ({mb_ok}, max |diff| {mb_err:.3e})")
        out["remat_microbatches"][arch] = dict(remat_max_abs_err=remat_err, remat_bound=LM_TRAIN_REMAT_BOUND,
                                               microbatch_loss_diff=mb_loss, microbatch_param_max_abs_diff=mb_err,
                                               microbatch_held=held)
        limits = "(< 2e-3)" if held else "(not held: the moe balance loss depends on the split)"
        say(f"[lm-train] {arch} b. remat on against off: gradients max |diff| {remat_err:.3e} (bound "
            f"{LM_TRAIN_REMAT_BOUND:g}); one step of 2 microbatches against 1: loss |diff| {mb_loss:.3e} {limits}, "
            f"parameters max |diff| {mb_err:.3e} (rtol 2e-2, atol 2e-4); {time.perf_counter() - t_arch:.2f} s [{card}]")
        del model, grads, state, steps, opt0
        torch.cuda.empty_cache()
    check(not failures, f"phase 4 a, b: {failures}")

    # -- c. checkpoint at full width ----------------------------------------------
    t0 = time.perf_counter()
    set_numerics()
    cfg = get_config(LM_ARCH)
    cut = replace(cfg, n_layers=LM_TRAIN_WITNESS[LM_ARCH])
    opt_cfg = AdamWConfig(lr=1e-3, warmup_steps=2)
    pipe = SyntheticTokenPipeline(vocab=LM_TRAIN_LEARN["data_vocab"], seq_len=128, global_batch=4, seed=LM_SEED)
    cbatches = [on_card(b) for b in pipe.structured_batches(3)]
    live = build_model(cut, device=dev, dtype=torch.bfloat16, generator=torch.Generator(device=dev).manual_seed(LM_SEED))
    step = make_train_step(live, opt_cfg)
    opt = adamw_init(live)
    for b in cbatches[:2]:
        opt, _ = step(opt, b)
    with tempfile.TemporaryDirectory() as tmp:
        t_save = time.perf_counter()
        save_train_state(tmp, params=live, opt_state=opt, step=2, meta={"arch": LM_ARCH})
        t_save = time.perf_counter() - t_save
        ckpt_bytes = sum(f.stat().st_size for f in Path(tmp).iterdir())
        restored = build_model(cut, device=dev, dtype=torch.bfloat16)
        t_load = time.perf_counter()
        restored, ropt, meta = load_train_state(tmp, restored, adamw_init(restored))
        torch.cuda.synchronize()
        t_load = time.perf_counter() - t_load
    check(meta == {"step": 2, "arch": LM_ARCH}, f"c. meta restored ({meta})")
    check(states_bitwise(restored.state_dict(), live.state_dict()) and states_bitwise(ropt, opt),
          "c. every parameter and optimizer leaf restored bitwise")
    opt, m_live = step(opt, cbatches[2])
    ropt, m_rest = make_train_step(restored, opt_cfg)(ropt, cbatches[2])
    check(states_bitwise(restored.state_dict(), live.state_dict()) and states_bitwise(ropt, opt)
          and torch.equal(m_live["loss"], m_rest["loss"]), "c. one step from the restored state equals one from the "
                                                           "live state, bitwise")
    n_leaves = len(dict(live.named_parameters()))
    out["checkpoint"] = dict(layers=cut.n_layers, params=sum(p.numel() for p in live.parameters()), leaves=n_leaves,
                             bytes=ckpt_bytes, save_s=t_save, load_s=t_load, bitwise=True)
    say(f"[lm-train] c. checkpoint of {cut.n_layers} layers at full width (bf16, f32 masters) after 2 steps: "
        f"{ckpt_bytes / 1e9:.3f} GB, saved in {t_save:.2f} s, loaded in {t_load:.2f} s; {n_leaves} parameters and "
        f"{3 * n_leaves + 1} optimizer leaves bitwise, and the next step from the restored state bitwise the live "
        f"one's; {time.perf_counter() - t0:.2f} s [{card}]")
    del live, restored, opt, ropt, step, cbatches
    torch.cuda.empty_cache()

    # -- d. learning at full width and depth --------------------------------------
    t0 = time.perf_counter()
    model = build_model(cfg, device=dev, dtype=torch.bfloat16, generator=torch.Generator(device=dev).manual_seed(LM_SEED))
    opt = adamw_init(model)
    n_params = sum(p.numel() for p in model.parameters())
    L = LM_TRAIN_LEARN
    step = make_train_step(model, AdamWConfig(lr=L["lr"], warmup_steps=L["warmup"]))
    pipe = SyntheticTokenPipeline(vocab=L["data_vocab"], seq_len=L["S"], global_batch=L["B"], seed=LM_SEED)
    metrics = []
    for b in pipe.structured_batches(L["steps"]):
        opt, m = step(opt, on_card(b))
        metrics.append(torch.stack([m["loss"], m["grad_norm"]]))
    lg = torch.stack(metrics).cpu()
    losses, gnorms = lg[:, 0].tolist(), lg[:, 1].tolist()
    check(all(math.isfinite(x) for x in losses + gnorms), "d. every loss and grad norm finite")
    drop = losses[0] - losses[-1]
    check(drop > LM_TRAIN_LEARN_MARGIN, f"d. the loss falls by more than {LM_TRAIN_LEARN_MARGIN:g} ({drop:.4f})")
    out["learning"] = dict(arch=LM_ARCH, params=n_params, steps=L["steps"], B=L["B"], S=L["S"],
                           data_vocab=L["data_vocab"], lr=L["lr"], warmup=L["warmup"], losses=losses,
                           grad_norms=gnorms, drop=drop, margin=LM_TRAIN_LEARN_MARGIN,
                           seconds=time.perf_counter() - t0)
    say(f"[lm-train] d. {LM_ARCH} at full width and depth ({n_params:,} parameters, bf16, f32 masters, remat): "
        f"{L['steps']} steps of {L['B']}x{L['S']} structured tokens over the first {L['data_vocab']} ids, lr "
        f"{L['lr']:g} after {L['warmup']} warmup steps: loss {losses[0]:.4f} -> {losses[-1]:.4f} (drop {drop:.4f}, "
        f"margin {LM_TRAIN_LEARN_MARGIN:g}), grad norm {gnorms[0]:.3f} -> {gnorms[-1]:.3f}; "
        f"{out['learning']['seconds']:.2f} s [{card}]")
    say(f"[lm-train]   losses {' '.join(f'{x:.4f}' for x in losses)}")

    # -- e. timing at train_4k's length -------------------------------------------
    T = LM_TRAIN_TIMING
    tstep = make_train_step(model, AdamWConfig(lr=L["lr"], warmup_steps=L["warmup"]), microbatches=T["microbatches"])
    tpipe = SyntheticTokenPipeline(vocab=cfg.vocab, seq_len=T["S"], global_batch=T["B"], seed=LM_SEED)
    tbatches = [on_card(b) for b in tpipe.batches(T["steps"] + 3)]
    state_bytes = sum(p.numel() * p.element_size() for p in model.parameters()) + sum(
        t.numel() * t.element_size() for k in ("master", "m", "v") for t in opt[k].values())
    opt, m = tstep(opt, tbatches[0])  # warm: the allocator's pools
    torch.cuda.synchronize()
    torch.cuda.reset_peak_memory_stats()
    start, end = torch.cuda.Event(enable_timing=True), torch.cuda.Event(enable_timing=True)
    t_host = time.perf_counter()
    start.record()
    for b in tbatches[1 : 1 + T["steps"]]:
        opt, m = tstep(opt, b)
    end.record()
    end.synchronize()
    host_ms = (time.perf_counter() - t_host) * 1e3 / T["steps"]
    step_ms = start.elapsed_time(end) / T["steps"]
    peak_gb = torch.cuda.max_memory_allocated() / 1e9
    check(math.isfinite(float(m["loss"])), "e. finite loss at S = 4096")

    def one_step():
        nonlocal opt
        opt, _ = tstep(opt, tbatches[-2])
        torch.cuda.synchronize()

    rows, busy_ms, wall_ms = device_profile(one_step)
    torch.cuda.set_sync_debug_mode("error")
    try:
        opt, m = tstep(opt, tbatches[-1])
    finally:
        torch.cuda.set_sync_debug_mode("default")
    torch.cuda.synchronize()
    g = torch.Generator(device=dev).manual_seed(LM_SEED + 4)
    fake = {n: 1e-3 * torch.randn(p.shape, generator=g, device=dev, dtype=opt["master"][n].dtype)
            for n, p in model.named_parameters()}  # f32, as accumulated microbatch gradients are
    opt_ms = time_ms(lambda: adamw_update(fake, opt, model, AdamWConfig()), iters=3, warmup=1)
    del fake
    shape = ShapeConfig("train_4k", T["S"], T["B"], "train")
    flops, nbytes = model_flops(cfg, shape), hbm_bytes_estimate(cfg, shape)
    t_ops, t_bytes = flops / BF16_FLOPS_PER_S * 1e3, nbytes / HBM_BYTES_PER_S * 1e3
    tokens = T["B"] * T["S"]
    e = dict(B=T["B"], S=T["S"], microbatches=T["microbatches"], cut=f"global batch 256 -> {T['B']}",
             steps=T["steps"], ms_per_step=step_ms, host_ms_per_step=host_ms, tokens_per_s=tokens / step_ms * 1e3, model_flops=flops,
             hbm_bytes=nbytes, bound_ms=max(t_ops, t_bytes), bound_by="operations" if t_ops >= t_bytes else "bytes",
             optimizer_ms=opt_ms, peak_gb=peak_gb, state_gb=state_bytes / 1e9, profile_busy_ms=busy_ms,
             profile_wall_ms=wall_ms, idle_share=1.0 - busy_ms / wall_ms, device_ops=sum(r[2] for r in rows),
             top_ops=[[name[:120], ms, count] for name, ms, count in rows[:5]], sync_free=True)
    out["timing"] = e
    say(f"[lm-train] e. {LM_ARCH} bf16 train step at B={T['B']} ({T['microbatches']} microbatches) x S={T['S']} "
        f"(train_4k's global batch 256 cut to {T['B']}), remat: {step_ms:.3f} ms a step ({e['tokens_per_s']:.1f} "
        f"tokens/s) over {T['steps']} steps; bound {e['bound_ms']:.3f} ms by {e['bound_by']} ({flops / 1e12:.3f} "
        f"TFLOP at 989 TFLOP/s, {nbytes / 1e9:.3f} GB at 3.35 TB/s), {step_ms / e['bound_ms']:.1f}x; the optimizer "
        f"update alone {opt_ms:.3f} ms; peak {peak_gb:.3f} GB allocated ({e['state_gb']:.3f} GB of weights, masters "
        f"and moments); 1 step: device busy {busy_ms:.3f} of {wall_ms:.3f} ms wall, idle {e['idle_share']:.1%}, "
        f"{e['device_ops']} device operations; one step ran under sync debug mode 'error' [{card}]")
    for name, ms, count in rows[:5]:
        say(f"[lm-train]   {ms:9.3f} ms {count:6d}x {name[:110]}")
    del model, opt, tbatches
    torch.cuda.empty_cache()
    out["seconds"] = time.perf_counter() - t_phase
    say(f"[lm-train] phase 4 wall time {out['seconds']:.2f} s [{card}]")
    return out


def lm_dist_phase() -> dict:
    """Phase 5: the LM distribution layer (``repro_torch.sharding.specs``,
    ``repro_torch.launch``, the active ``DistContext`` and
    ``sharded_decode_attention``) on an NCCL process group of one rank
    (``HashStore``) and a (1, 1) ("data", "model") mesh on the card. (a)
    qwen2-0.5b at full width and depth in bf16 from phase 3's seed, its
    parameters placed by ``param_pspecs`` as DTensors and
    ``DistContext(batch_axes=("data",), model_axis="model")`` active inside
    ``mesh_scope``, against the same weights with an inactive context:
    prefill logits and greedy decode steps (``LM_DIST``), within
    ``LM_DIST_ACTIVE_BOUND`` (0: bitwise). (b) ``sharded_decode_attention``
    over the one-rank group at qwen2-0.5b's decode width (``LM_DIST_FLASH``,
    14 heads over 2 kv heads of 64, bf16 cache) against ``decode_attention``
    on the same cache in float64 within 1e-12, and the card's f32 (bf16
    cache) against its f64 within ``LM_DIST_FLASH_F32_VS_F64``; both timed
    by CUDA events. (c) ``run_cell`` of qwen2-0.5b ``decode_32k`` at a batch
    of ``LM_DIST_DRYRUN_B`` on the mesh: its per-rank argument bytes equal
    the storage bytes of those parameters, cache and tokens materialized on
    the card, and the growth of ``torch.cuda.memory_allocated()`` with each
    tensor rounded up to the caching allocator's 512-byte block; the decode
    step's FLOPs counted on the card equal those counted on meta. The phase
    destroys its process group at its end."""
    from dataclasses import replace

    import torch.distributed as dist
    from torch.distributed.device_mesh import init_device_mesh

    from repro_torch.configs import SHAPES, get_config
    from repro_torch.launch.dryrun import run_cell
    from repro_torch.launch.mesh import mesh_axis_sizes, mesh_scope
    from repro_torch.launch.step_analysis import analyze_step
    from repro_torch.models import build_model
    from repro_torch.models.attention import decode_attention, sharded_decode_attention
    from repro_torch.models.zoo import DistContext
    from repro_torch.sharding.specs import batch_pspecs, cache_pspecs, param_pspecs, place, place_model, place_tree

    t_phase = time.perf_counter()
    set_numerics()
    card = card_line()
    dev = torch.device("cuda")
    cfg = get_config(LM_ARCH)
    dist.init_process_group("nccl", store=dist.HashStore(), world_size=1, rank=0,
                            device_id=torch.device("cuda", torch.cuda.current_device()))
    try:
        mesh = init_device_mesh("cuda", (1, 1), mesh_dim_names=("data", "model"))
        axes, sizes = tuple(mesh.mesh_dim_names), mesh_axis_sizes(mesh)

        # -- a. the active context at full width ---------------------------------
        t0 = time.perf_counter()
        plain = build_model(cfg, device=dev, dtype=torch.bfloat16, generator=torch.Generator().manual_seed(LM_SEED))
        active = build_model(cfg, DistContext(batch_axes=("data",), model_axis="model"), device=dev,
                             dtype=torch.bfloat16)
        active.load_state_dict(plain.state_dict())
        place_model(active, param_pspecs(cfg, active, axes, sizes), mesh)
        g = torch.Generator().manual_seed(LM_SEED + 5)
        Bp, Sp = LM_DIST["prefill_B"], LM_DIST["prefill_S"]
        tokens = torch.randint(0, cfg.vocab, (Bp, Sp), generator=g).to(dev)
        b_spec = batch_pspecs(cfg, SHAPES["prefill_32k"], axes)
        with torch.no_grad():
            want = plain.logits({"tokens": tokens})
            with mesh_scope(mesh):
                got = active.logits({"tokens": place(tokens, b_spec["tokens"], mesh)}).full_tensor()
        check(got.shape == want.shape == (Bp, Sp, cfg.vocab) and bool(torch.isfinite(want).all()),
              "phase 5 a: prefill logits finite")
        prefill_err = max_err(got, want)
        Bd, T = LM_DIST["decode_B"], LM_DIST["decode_T"]
        cache = plain.init_cache(Bd, T, torch.bfloat16)
        placed = place_tree({k: v.clone() for k, v in cache.items()},
                            cache_pspecs(cfg, SHAPES["decode_32k"], cache, axes, sizes), mesh)
        t_spec = batch_pspecs(cfg, SHAPES["decode_32k"], axes)["tokens"]
        tok = torch.randint(0, cfg.vocab, (Bd, 1), generator=g).to(dev)
        decode_errs = []
        for _ in range(LM_DIST["steps"]):
            want_step, cache = plain.decode(tok, cache)
            with mesh_scope(mesh):
                got_step, placed = active.decode(place(tok, t_spec, mesh), placed)
            decode_errs.append(max_err(got_step.full_tensor(), want_step))
            tok = want_step[:, -1:].argmax(dim=-1)
        cache_err = max(max_err(placed[k].full_tensor(), cache[k]) for k in ("k", "v"))
        a = dict(prefill_B=Bp, prefill_S=Sp, prefill_max_err=prefill_err, decode_B=Bd, decode_T=T,
                 decode_steps=LM_DIST["steps"], decode_max_err=max(decode_errs), cache_max_err=cache_err,
                 bound=LM_DIST_ACTIVE_BOUND, seconds=time.perf_counter() - t0)
        say(f"[lm-dist] a. {LM_ARCH} full width and depth, bf16, active DistContext on the (1, 1) NCCL mesh "
            f"against the inactive model: prefill B={Bp} S={Sp} logits max |diff| {prefill_err:.3e}, "
            f"{LM_DIST['steps']} decode steps B={Bd} T={T} max |diff| {a['decode_max_err']:.3e}, caches "
            f"{cache_err:.3e} (bound {LM_DIST_ACTIVE_BOUND:g}) [{card}]")
        check(max(prefill_err, a["decode_max_err"], cache_err) <= LM_DIST_ACTIVE_BOUND,
              f"phase 5 a: the active context within {LM_DIST_ACTIVE_BOUND:g} of the inactive one")
        del plain, active, cache, placed, want, got
        torch.cuda.empty_cache()

        # -- b. sharded_decode_attention over the one-rank group -------------------
        B, T = LM_DIST_FLASH["B"], LM_DIST_FLASH["T"]
        H, Hkv, d = cfg.n_heads, cfg.n_kv, cfg.hd
        g = torch.Generator(device=dev).manual_seed(LM_SEED + 6)
        q = torch.randn((B, 1, H, d), generator=g, device=dev)
        k = torch.randn((B, T, Hkv, d), generator=g, device=dev).to(torch.bfloat16)
        v = torch.randn((B, T, Hkv, d), generator=g, device=dev).to(torch.bfloat16)
        group = dist.group.WORLD
        f64 = sharded_decode_attention(q.double(), k.double(), v.double(), group=group)
        f64_err = max_err(f64, decode_attention(q.double(), k.double(), v.double()))
        f32 = sharded_decode_attention(q, k, v, group=group)
        f32_err = max_err(f32, f64)
        times = median_ms({"sharded_decode_attention": lambda: sharded_decode_attention(q, k, v, group=group),
                           "decode_attention": lambda: decode_attention(q, k, v)}, 10)
        b = dict(B=B, T=T, H=H, Hkv=Hkv, d=d, cache_dtype="bf16", f64_vs_decode_attention=f64_err,
                 f32_vs_f64=f32_err, f32_bound=LM_DIST_FLASH_F32_VS_F64, sharded_ms=times["sharded_decode_attention"][0],
                 decode_attention_ms=times["decode_attention"][0], quartiles_ms={n: t[1:] for n, t in times.items()})
        say(f"[lm-dist] b. sharded_decode_attention over the one-rank NCCL group, B={B} T={T} H={H}/{Hkv} d={d}, "
            f"bf16 cache: f64 against decode_attention {f64_err:.3e} (bound 1e-12); f32 against its f64 "
            f"{f32_err:.3e} (bound {LM_DIST_FLASH_F32_VS_F64:g}); {b['sharded_ms']:.3f} ms against "
            f"decode_attention's {b['decode_attention_ms']:.3f} ms (medians of 10) [{card}]")
        check(f64_err <= 1e-12, f"phase 5 b: f64 flash-decode within 1e-12 ({f64_err:.3e})")
        check(f32_err <= LM_DIST_FLASH_F32_VS_F64, f"phase 5 b: f32 within {LM_DIST_FLASH_F32_VS_F64:g} of f64")
        del q, k, v, f64, f32
        torch.cuda.empty_cache()

        # -- c. the dry run's bytes made real ------------------------------------
        shape = replace(SHAPES["decode_32k"], global_batch=LM_DIST_DRYRUN_B)
        res = run_cell(cfg, shape, mesh, verbose=False)
        # expandable segments: a block is split off its segment whenever 512
        # bytes or more remain, so each allocation holds its size rounded up
        # to 512 bytes (without them, a large block that leaves up to 1 MB of
        # its segment keeps the rest)
        torch.cuda.synchronize()
        torch.cuda.empty_cache()
        torch.cuda.memory._set_allocator_settings("expandable_segments:True")
        try:
            mem0, req0 = torch.cuda.memory_allocated(), torch.cuda.memory_stats()["requested_bytes.all.current"]
            model = build_model(cfg, DistContext(batch_axes=("data",), model_axis="model"), device=dev,
                                dtype=torch.bfloat16)
            cache = model.init_cache(shape.global_batch, shape.seq_len, torch.bfloat16)
            token = torch.zeros((shape.global_batch, 1), dtype=torch.int32, device=dev)
            torch.cuda.synchronize()
            grown = torch.cuda.memory_allocated() - mem0
            requested = torch.cuda.memory_stats()["requested_bytes.all.current"] - req0
        finally:
            torch.cuda.memory._set_allocator_settings("expandable_segments:False")
        real = [*model.parameters(), *cache.values(), token]
        storage = sum(t.untyped_storage().nbytes() for t in real)
        blocks = sum(-(-t.untyped_storage().nbytes() // 512) * 512 for t in real)
        place_model(model, param_pspecs(cfg, model, axes, sizes), mesh)
        placed = place_tree(cache, cache_pspecs(cfg, shape, cache, axes, sizes), mesh)
        with torch.no_grad(), mesh_scope(mesh):
            _, stats = analyze_step(model.decode, place(token, batch_pspecs(cfg, shape, axes)["tokens"], mesh), placed)
        torch.cuda.synchronize()
        c = dict(shape=f"decode_32k at B={shape.global_batch}", argument_bytes=res["memory"]["argument_bytes"],
                 argument_bytes_by_kind=res["memory"]["argument_bytes_by_kind"], storage_bytes=storage,
                 allocator_growth=grown, requested_growth=requested, block_rounded_bytes=blocks, flops_meta=res["flops"]["counted_cluster"],
                 flops_card=stats.flops, model_flops=res["flops"]["model_cluster"], trace_s=res["trace_s"])
        say(f"[lm-dist] c. run_cell {LM_ARCH} {c['shape']} on the (1, 1) cuda mesh: argument bytes "
            f"{c['argument_bytes']} ({json.dumps(c['argument_bytes_by_kind'])}); materialized on the card: storage "
            f"{storage} bytes ({requested} requested), allocator growth {grown} bytes against {blocks} rounded to "
            f"512-byte blocks; decode "
            f"FLOPs counted on the card {stats.flops:.6e}, on meta {c['flops_meta']:.6e} [{card}]")
        check(storage == c["argument_bytes"], "phase 5 c: the materialized bytes equal the dry run's argument bytes")
        check(requested == storage, "phase 5 c: the allocator was asked for the materialized bytes")
        check(grown == blocks, "phase 5 c: the allocator grew by the block-rounded bytes")
        check(stats.flops == c["flops_meta"], "phase 5 c: the card's decode FLOPs equal the meta count")
        del model, cache, placed, token
        torch.cuda.empty_cache()
    finally:
        dist.destroy_process_group()
    out = dict(card=card, arch=LM_ARCH, mesh=[1, 1], active=a, flash_decode=b, dryrun_bytes=c,
               seconds=time.perf_counter() - t_phase)
    say(f"[lm-dist] phase 5 wall time {out['seconds']:.2f} s [{card}]")
    return out


def main(lm: bool = True) -> int:
    """The whole script; ``lm=False`` (``--only cavity``) runs phases 1, 2 to
    2c and 6 and prints the kernels line, without the LM phases 3 to 5 and
    the cross-check of phase 7."""
    if not torch.cuda.is_available():
        print("chip_smoke: no CUDA device is available", file=sys.stderr)
        return 2
    set_numerics()

    from repro_torch import telemetry
    from repro_torch.analysis import RetraceSentinel, budget_findings, load_config, render
    from repro_torch.analysis.engine_plans import verify_engine_plans
    from repro_torch.kernels.lbm_collide import build as kbuild
    from repro_torch.kernels.lbm_collide.lbm_collide import (
        HaloMap,
        kernel_attributes,
        lbm_halo_fill,
        lbm_stream_collide,
        lbm_stream_collide_halo,
        member_coeffs,
        reset_launches,
    )
    from repro_torch.kernels.lbm_collide.ops import (
        _assert_fills_disjoint,
        _concat_vals,
        _lower_fill_gathers,
        _pad_fill_layout,
        _rank_rows,
        _same_fill,
        boundary_slot_sets,
        cube_groups,
        face_neighbours,
        fill_tables,
        halo_map,
        make_stream_collide,
        message_tables,
        neighbour_order,
    )
    from repro_torch.kernels.lbm_collide.ref import (
        collision_coeffs,
        halo_fill_ref,
        halo_stream_collide_ref,
        stream_collide_coeffs,
        stream_collide_into,
        stream_collide_ref,
    )
    from repro_torch.lbm.criteria import macroscopic
    from repro_torch.lbm.driver import AMRLBM, LidDrivenCavityConfig
    from repro_torch.lbm.forests import refined_forest
    from repro_torch.lbm.halo import compile_ghost_plan, lower_halo_fill
    from repro_torch.lbm.lattice import D3Q19, D3Q27, omega_for_level
    from repro_torch.particles import ParticlesConfig, all_particles
    from repro_torch.serving import Ensemble, JobSpec, SimulationService, resize_ranks, topology_key
    from repro_torch.state import export_state, load_state

    def launch_counts() -> dict:
        out = {fn.__name__: fn.launches for fn in (lbm_stream_collide, lbm_halo_fill, lbm_stream_collide_halo)}
        out["lbm_stream_collide[slots]"] = lbm_stream_collide.slot_launches
        out["lbm_stream_collide[members]"] = lbm_stream_collide.member_launches
        out["lbm_stream_collide[halo]"] = lbm_stream_collide.halo_launches
        out["lbm_stream_collide[halo+slots]"] = lbm_stream_collide.halo_slot_launches
        out["lbm_stream_collide[halo+members]"] = lbm_stream_collide.halo_member_launches
        out.update({f"lbm_halo_fill[{k}]": n for k, n in lbm_halo_fill.kind_launches.items()})
        out["lbm_halo_fill[members]"] = sum(n for k, n in lbm_halo_fill.kind_launches.items() if k.endswith("+members"))
        return out
    card = card_line()
    say("card:", card)
    say(
        "torch", torch.__version__, "cuda", torch.version.cuda,
        "device", torch.cuda.get_device_name(0), "count", torch.cuda.device_count(),
    )

    # -- 1. build ---------------------------------------------------------------
    t0 = time.perf_counter()
    lib_paths, log = kbuild.build()
    say(f"build: {', '.join(p.name for p in lib_paths)} in {time.perf_counter() - t0:.2f} s "
        f"({len(lib_paths)} nvcc at once, one a (dtype, Q) part, sm_90a)")
    if log:
        for line in log.splitlines():
            if "Compiling entry" in line or "registers" in line or "spill" in line:
                say("  ptxas:", line.strip())
        check(bool(re.search(r"bytes spill stores", log)), "ptxas reported its spills")
    attrs = kernel_attributes()
    for r in attrs:
        say(f"  kernel {r['kernel']:7s} {r['variant']:16s} {r['dtype']} Q={r['Q']}: "
            f"{r['registers']} registers, {r['local_bytes']} local (spill) bytes, {r['shared_bytes']} shared bytes, "
            f"{r['ctas_per_sm']} CTAs of 256 per SM, occupancy {r['occupancy']:.1%}")
    # the f32 D3Q19 stencils are capped at 64 registers (4 CTAs of 256
    # threads, 50 % occupancy); no instantiation may spill
    for r in attrs:
        check(r["local_bytes"] == 0, f"no local memory: {r}")
    check(not re.search(r"[1-9]\d* bytes spill", log or ""), "ptxas reported no spill")
    main_stencil = next(r for r in attrs if r["kernel"] == "stencil" and r["variant"] == "trt"
                        and r["dtype"] == "f32" and r["Q"] == 19)
    check(main_stencil["occupancy"] >= 0.5, "the f32 D3Q19 TRT stencil keeps 50 % occupancy")
    member_stencil = next(r for r in attrs if r["kernel"] == "stencil" and r["variant"] == "trt+members"
                          and r["dtype"] == "f32" and r["Q"] == 19)
    main_fills = [r for r in attrs if r["kernel"] == "fill" and r["dtype"] == "f32" and r["Q"] == 19
                  and r["variant"] in ("copy", "fine")]
    halo_stencils = {v: next(r for r in attrs if r["kernel"] == "stencil" and r["variant"] == v
                             and r["dtype"] == "f32" and r["Q"] == 19)
                     for v in ("trt+halo", "trt+halo+payloads", "trt+slots+halo", "trt+slots+halo+payloads",
                               "trt+halo+members")}

    # -- 2. main paths: the full cavity, fused, arena and fused_sharded -----------
    def blocks_per_level(sim) -> dict:
        return dict(sorted(Counter(b.level for b in sim.forest.all_blocks()).items()))

    def blocks_per_rank(sim) -> dict:
        per = {}
        for b in sim.forest.all_blocks():
            per.setdefault(b.owner, Counter())[b.level] += 1
        return {r: dict(sorted(c.items())) for r, c in sorted(per.items())}

    def forest_of(sim) -> set:
        return {(b.bid, b.level, b.owner) for b in sim.forest.all_blocks()}

    def transfers_of(sim) -> tuple[int, int]:
        res_ = sim.engine.residencies()
        return sum(r.h2d_transfers for r in res_), sum(r.d2h_transfers for r in res_)

    def drive_cavity(mode: str, protocol: list | None = None, **over):
        """``AMRLBM(cfg).run(12, amr_interval=4)``, unrolled so each coarse
        step and AMR event is timed; launch counts zeroed just before and
        read just after. Peak memory is counted above what was allocated
        before the run (an earlier run's simulation stays resident). With
        ``protocol`` (a list), the plans the engine holds after the first two
        AMR events are verified, and (event, findings, seconds) appended to
        it: event 1's after step 5, event 2's after step 11, the last step
        before event 3, so that the checks' host work and allocations stay
        out of the steady window (steps 10 and 11); the main path's wall
        time leaves those seconds out."""
        cfg = LidDrivenCavityConfig(stepping_mode=mode, kernel_backend="cuda", **FULL_CAVITY, **over)
        say(f"[{mode}] main path config:",
            json.dumps({k: v for k, v in vars(cfg).items() if k != "obstacle_fn"}))
        torch.cuda.synchronize()
        mem0 = torch.cuda.memory_allocated()
        torch.cuda.reset_peak_memory_stats()
        reset_launches()
        t_main = time.perf_counter()
        sim = AMRLBM(cfg)
        check(sim.device.type == "cuda", "the main path runs on the card")
        mass0 = sim.total_mass()
        step_s, amr_s, transfers, levels_at, comm_at, forests = [], [], [], [], [], []
        verify_s = 0.0
        for i in range(12):
            levels_at.append(blocks_per_level(sim))
            transfers.append(transfers_of(sim))
            comm_at.append({**sim.comm.stats.summary(), "pad": getattr(sim.comm, "ppermute_pad_bytes", 0)})
            torch.cuda.synchronize()
            t0 = time.perf_counter()
            sim.advance(1)  # device modes: ends in a device synchronize; arena: copies back
            step_s.append(time.perf_counter() - t0)
            if protocol is not None and i in (4, 10):  # the engine now holds the plans of event i // 4
                t0 = time.perf_counter()
                protocol.append((i // 4, verify_engine_plans(sim), time.perf_counter() - t0))
                verify_s += protocol[-1][2]
            if (i + 1) % 4 == 0:
                t0 = time.perf_counter()
                sim.adapt()
                amr_s.append(time.perf_counter() - t0)
                forests.append(forest_of(sim))
        transfers.append(transfers_of(sim))
        comm_at.append({**sim.comm.stats.summary(), "pad": getattr(sim.comm, "ppermute_pad_bytes", 0)})
        mass1 = sim.total_mass()
        torch.cuda.synchronize()
        main_s = time.perf_counter() - t_main - verify_s
        launches = launch_counts()
        peak_gb = (torch.cuda.max_memory_allocated() - mem0) / 1e9
        # steady state: steps 10 and 11 (step 9 follows the second AMR event:
        # the device modes upload and build their programs there; step 12 is
        # followed by an AMR event)
        steady = range(9, 11)
        steady_s = sum(step_s[i] for i in steady)
        forest_steady = levels_at[10]
        check(sim.coarse_step == 12 and sim.amr_cycles >= 2, "12 coarse steps spanning two AMR events")
        check(len(forest_steady) == 3, f"three levels step after the second AMR event: {forest_steady}")
        cells = int(np.prod(cfg.cells_per_block))
        updates = sum(n * cells * 2**l for l, n in forest_steady.items())
        say(f"[{mode}] blocks per level during steps 9-12:", json.dumps(forest_steady))
        say(f"[{mode}] blocks per level after step 12:", json.dumps(blocks_per_level(sim)))
        say(f"[{mode}] blocks per rank and level after step 12:", json.dumps(blocks_per_rank(sim)))
        say(f"[{mode}] peak device memory: {peak_gb:.3f} GB")
        say(f"[{mode}] coarse step wall times (s):", json.dumps([round(t, 4) for t in step_s]))
        say(f"[{mode}] AMR event wall times (s):", json.dumps([round(t, 3) for t in amr_s]))
        rate = len(steady) / steady_s
        say(
            f"[{mode}] steady state (steps 10-11): {rate:.3f} coarse steps/s, "
            f"{updates * len(steady) / steady_s / 1e6:.1f} MLUPS "
            f"({updates} interior cell updates per coarse step)"
        )
        say(f"[{mode}] main path wall time {main_s:.2f} s")
        drift = abs(mass1 - mass0) / mass0
        say(f"[{mode}] mass: {mass0:.6f} -> {mass1:.6f}, relative drift {drift:.3e} (limit 1e-5)")
        check(drift <= 1e-5, "mass drift within 1e-5 relative")
        if mode != "arena":
            t_a, t_b = transfers[steady.start], transfers[steady.stop]
            say(f"[{mode}] steady-state h2d/d2h transfers over steps 10-11: "
                f"{t_b[0] - t_a[0]}/{t_b[1] - t_a[1]}")
            check(t_a == t_b, "zero host<->device transfers in steady state")
        comm = None
        if mode in ("fused_sharded", "device_sharded"):
            c_a, c_b = comm_at[steady.start], comm_at[steady.stop]
            nsub = len(steady) * 2 ** max(forest_steady)
            comm = {k: (c_b[k] - c_a[k]) / nsub for k in ("p2p_bytes", "p2p_messages", "pad")}
            say(f"[{mode}] {type(sim.comm).__name__} p2p traffic over steps 10-11: "
                f"{comm['p2p_bytes']:.0f} bytes and {comm['p2p_messages']:.1f} messages per substep "
                f"({nsub} substeps), {c_b['collective_bytes_per_rank'] - c_a['collective_bytes_per_rank']} "
                f"collective bytes per rank" + (f", {comm['pad']:.0f} pad bytes per substep" if comm["pad"] else ""))
        say(f"[{mode}] kernel launches:", json.dumps(launches))
        sim.materialize_host()
        for b in sim.forest.all_blocks():
            check(bool(np.isfinite(sim.spec.interior(b.data["pdf"])).all()), "finite interior pdfs")
        return sim, launches, forests, dict(peak_gb=peak_gb, rate=rate, comm=comm)

    # fused: one halo-route launch a filled level, a stencil a level without;
    # arena: the stencil alone, with a host round trip every substep;
    # fused_sharded: the same kernels per rank, with device-built messages
    # read by the halo route, over slot lists in the split
    # the protocol verifier's findings at the AMR events of the fused and
    # fused_sharded runs, read in phase 2c
    protocol_at = {"fused": [], "fused_sharded": []}
    sim, fused_launches, fused_forests, _ = drive_cavity("fused", protocol=protocol_at["fused"])
    check(fused_launches["lbm_stream_collide[halo]"] > 0, "the stencil's halo route launched on the fused path")
    check(fused_launches["lbm_halo_fill"] == 0, "no separate fill launched on the fused path")
    check(fused_launches["lbm_stream_collide"] >= fused_launches["lbm_stream_collide[halo]"],
          "the halo route counts among the stencil's launches")
    _arena_sim, arena_launches, _, _ = drive_cavity("arena")
    check(arena_launches["lbm_stream_collide"] > 0, "the stencil kernel launched on the arena path")
    del _arena_sim
    fs, fs_launches, fs_forests, fs_info = drive_cavity("fused_sharded", protocol=protocol_at["fused_sharded"])
    check(fs.engine.split, "fused_sharded splits interior and boundary blocks on the card")
    for key in ("lbm_stream_collide", "lbm_stream_collide[slots]", "lbm_stream_collide[halo]",
                "lbm_stream_collide[halo+slots]"):
        check(fs_launches[key] > 0, f"{key} launched on the fused_sharded path")
    check(fs_launches["lbm_halo_fill"] == 0, "no separate fill launched on the fused_sharded path")
    check(fs_forests == fused_forests, "fused_sharded grew the fused forest at every AMR event")
    fused_blocks = {b.bid: b for b in sim.forest.all_blocks()}
    for b in fs.forest.all_blocks():
        check(np.array_equal(fs.spec.interior(b.data["pdf"]), sim.spec.interior(fused_blocks[b.bid].data["pdf"])),
              f"block {b.bid:#x}: fused_sharded interior bitwise equal to fused's")
    say(f"[fused_sharded] forest equal to fused's after each of {len(fs_forests)} AMR events; "
        f"all {len(fused_blocks)} block interiors bitwise equal to fused's after step 12")

    # device_sharded: the 4 ranks share the one card, as fused_sharded's do
    ds, ds_launches, ds_forests, ds_info = drive_cavity("device_sharded", rank_devices=SHARED_CARD)
    check(ds.engine.rank_devices == (torch.device("cuda:0"),) * FULL_CAVITY["nranks"], "every rank on cuda:0")
    for key in ("lbm_stream_collide", "lbm_stream_collide[halo]"):
        check(ds_launches[key] > 0, f"{key} launched on the device_sharded path")
    check(ds_launches["lbm_halo_fill"] == 0, "no separate fill launched on the device_sharded path")
    check(ds_forests == fused_forests, "device_sharded grew the fused forest at every AMR event")
    for b in ds.forest.all_blocks():
        check(np.array_equal(ds.spec.interior(b.data["pdf"]), sim.spec.interior(fused_blocks[b.bid].data["pdf"])),
              f"block {b.bid:#x}: device_sharded interior bitwise equal to fused's")
    say(f"[device_sharded] forest equal to fused's after each of {len(ds_forests)} AMR events; "
        f"all {len(fused_blocks)} block interiors bitwise equal to fused's after step 12")
    for key in ("p2p_bytes", "p2p_messages"):
        check(ds_info["comm"][key] == fs_info["comm"][key],
              f"device_sharded's DeviceComm {key} per substep equal fused_sharded's Comm numbers: "
              f"{ds_info['comm'][key]} vs {fs_info['comm'][key]}")
    say(f"[device_sharded] DeviceComm per substep over steps 10-11: {ds_info['comm']['p2p_bytes']:.0f} bytes, "
        f"{ds_info['comm']['p2p_messages']:.1f} messages (fused_sharded's Comm: {fs_info['comm']['p2p_bytes']:.0f} "
        f"bytes, {fs_info['comm']['p2p_messages']:.1f} messages), {ds_info['comm']['pad']:.0f} pad bytes; "
        f"{ds.comm.ppermute_rounds} ppermute rounds and {ds.comm.ppermute_pad_bytes} pad bytes over the run")
    held = ds.engine.device_held_bytes_by_rank()
    check(len(set(held)) == 1, f"every rank's device holds the same bytes: {held}")
    check(ds.engine.device_held_bytes_per_rank() == held[0], "device_held_bytes_per_rank is the bytes of each rank")
    say(f"[device_sharded] padded stacks held per rank device after step 12: {held[0] / 1e9:.3f} GB on each of "
        f"{len(held)} ranks; peak device memory {ds_info['peak_gb']:.3f} GB against fused_sharded's "
        f"{fs_info['peak_gb']:.3f} GB; steady rate {ds_info['rate']:.3f} against fused_sharded's "
        f"{fs_info['rate']:.3f} coarse steps/s")
    cfg = sim.cfg
    res = sim.arena.device()

    # where a steady fused coarse step spends device time, by kernel name
    sim.advance(1)  # the superstep is rebuilt after the last AMR event
    halo_steps = sim.engine._fused_program()[0].halo_steps
    rows, busy_ms, wall_ms = device_profile(lambda: sim.advance(2))  # ends in a device synchronize
    say(f"[fused] profile of 2 steady coarse steps: device busy {busy_ms:.3f} ms of "
        f"{wall_ms:.3f} ms wall, idle share {1 - busy_ms / wall_ms:.1%}")
    for name, ms, count in rows[:10]:
        say(f"  {ms:9.3f} ms {ms / busy_ms:6.1%} x{count:<5d} {name[:110]}")
    banned = [r[0] for r in rows if re.search(r"index|gather|scatter|cat", r[0], re.IGNORECASE)]
    check(not banned, f"no index gather, scatter or cat in the steady fused step: {banned}")
    fills_seen = sum(r[2] for r in rows if "halo_fill_kernel" in r[0])
    halo_seen = sum(r[2] for r in rows if STENCIL_NAME.search(r[0]) and STENCIL_NAME.search(r[0]).group(3) == "true")
    say(f"[fused] fill launches in 2 steady coarse steps: {fills_seen}; halo-route stencil launches {halo_seen} "
        f"(one per filled active level a substep: {2 * halo_steps})")
    check(fills_seen == 0 and halo_seen == 2 * halo_steps,
          "zero fill launches and one halo launch per filled active level a substep")

    # the superstep's rebuild after an AMR event (host work): whole, then
    # piece by piece on the same forest
    eng = sim.engine
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    eng._fused_fn = None
    eng._fused_program()
    torch.cuda.synchronize()
    build_s = time.perf_counter() - t0
    levels = sim.arena.levels()
    lmax = levels[-1]
    index = {l: i for i, l in enumerate(levels)}
    slots = {l: sim.arena.slots(l) for l in levels}
    nblocks = [sim.arena.num_blocks(l) for l in levels]
    cells = int(np.prod(sim.arena.buffer(lmax, "pdf").shape[2:]))
    t0 = time.perf_counter()
    plans = [compile_ghost_plan(sim.forest, sim.fields, slots, fields=("pdf",),
                                levels={l for l in levels if l >= lmax - p}) for p in range(lmax + 1)]
    plans_s = time.perf_counter() - t0
    t0 = time.perf_counter()
    pattern_fills = [lower_halo_fill(pl) for pl in plans]
    lower_s = time.perf_counter() - t0
    t0 = time.perf_counter()
    for fl in pattern_fills:
        _assert_fills_disjoint(fl, index, nblocks, cells)
    disjoint_s = time.perf_counter() - t0
    t0 = time.perf_counter()
    for fl in pattern_fills:
        for f in fl.values():
            fill_tables(f, index, "cuda")
    torch.cuda.synchronize()
    tables_s = time.perf_counter() - t0
    distinct = []
    for fl in pattern_fills:
        for l, f in fl.items():
            if not any(l == m and _same_fill(f, g) for m, g in distinct):
                distinct.append((l, f))
    n_fills = sum(len(fl) for fl in pattern_fills)
    say(f"[fused] superstep rebuild: {build_s:.3f} s. Its pieces, timed alone: ghost plans of "
        f"{len(plans)} patterns {plans_s:.3f} s, merged fills {lower_s:.3f} s, disjointness checks "
        f"{disjoint_s:.3f} s, fill tables of all {n_fills} (pattern, level) fills {tables_s:.3f} s "
        f"(the build makes tables for the {len(distinct)} distinct ones)")

    # where a steady fused_sharded coarse step spends device time: the halo
    # route and the plain stencil (whole and over slot lists), the emit
    # gathers; no fill. Printed beside the same profile of the fills-then-
    # stencils absorb (H100 80GB HBM3, 700 W: busy 30.314-30.339 ms, idle
    # 54.9-57.6 %, 1,479 operations; PERF.md, section 6)
    def rank_groups(rows) -> tuple[Counter, Counter]:
        groups, group_ms = Counter(), Counter()
        for name, ms, count in rows:
            m_sten = STENCIL_NAME.search(name)
            if "halo_fill_kernel" in name:
                key = "fill"
            elif m_sten:
                key = ("halo route" if m_sten.group(3) == "true" else "stencil") + (
                    " (slot list)" if m_sten.group(1) == "true" else "")
            elif re.search(r"memcpy", name, re.IGNORECASE):
                key = "payload copies"
            else:
                key = "emit gathers and other"
            groups[key] += count
            group_ms[key] += ms
        return groups, group_ms

    def map_bytes(steps) -> int:
        return sum(h.map_bytes for h in {id(h): h for h in steps}.values())

    fs.advance(1)  # the rank programs are rebuilt after the last AMR event
    progs = fs.engine._programs()
    fs_programs = [fn for p in progs.pattern for table in (progs.absorbs, progs.interiors, progs.boundaries)
                   for fn in table[p].values()]
    fill_expect = sum(fn.fill_segments for fn in fs_programs)  # a coarse step's, as the programs count them
    halo_expect = sum(fn.halo_steps for fn in fs_programs)
    fs_maps = [h for f in progs.factories.values() for h in f.steps()]
    say(f"[fused_sharded] rank maps after the last AMR event: {len(fs_maps)} distinct halo steps, "
        f"{map_bytes(fs_maps) / 1e9:.4f} GB of maps (8 bytes a cell)")
    c0 = fs.comm.stats.summary()
    fs_host = []
    fs_rows, fs_busy_ms, fs_wall_ms = device_profile(lambda: fs.advance(2), fs_host)
    c1 = fs.comm.stats.summary()
    groups, group_ms = rank_groups(fs_rows)
    say(f"[fused_sharded] profile of 2 steady coarse steps: device busy {fs_busy_ms:.3f} ms of "
        f"{fs_wall_ms:.3f} ms wall, idle share {1 - fs_busy_ms / fs_wall_ms:.1%}, {sum(groups.values())} device "
        f"operations (fills then stencils: busy 30.314-30.339 ms, idle 54.9-57.6 %, 1,479 operations)")
    for name, ms, count in fs_rows[:14]:
        say(f"  {ms:9.3f} ms {ms / fs_busy_ms:6.1%} x{count:<5d} {name[:110]}")
    for key in sorted(groups):
        say(f"[fused_sharded] {key}: {groups[key]} launches, {group_ms[key]:.3f} ms in 2 steady coarse steps")
    nsub2 = 2 * progs.nsub
    say(f"[fused_sharded] Comm during the profile: {(c1['p2p_bytes'] - c0['p2p_bytes']) / nsub2:.0f} bytes, "
        f"{(c1['p2p_messages'] - c0['p2p_messages']) / nsub2:.1f} messages per substep")
    banned = [r[0] for r in fs_rows if re.search(r"scatter|index_put", r[0], re.IGNORECASE)]
    check(not banned, f"no index scatter in the steady fused_sharded step: {banned}")
    halo_seen = groups["halo route"] + groups["halo route (slot list)"]
    say(f"[fused_sharded] fill launches in 2 steady coarse steps: {groups['fill']}; halo-route launches {halo_seen} "
        f"({groups['halo route (slot list)']} over slot lists; the programs count {2 * halo_expect})")
    check(fill_expect == 0 and groups["fill"] == 0, "no fill launch in the steady fused_sharded step")
    check(halo_seen == 2 * halo_expect, f"halo-route launches {halo_seen} == the programs' count {2 * halo_expect}")
    check(groups["halo route (slot list)"] > 0, "the halo route over a slot list ran in the steady fused_sharded step")

    # where a steady device_sharded coarse step spends device time: the same
    # kernels over the padded stacks, emit gathers, payload copies (fills
    # then stencils: busy 30.675-30.691 ms, idle 45.5-47.3 %, 1,539
    # operations)
    ds.advance(1)  # the device superstep is rebuilt after the last AMR event
    ds_progs = ds.engine._programs()
    ds_fn = ds_progs.fn
    ds_counts = ds_progs.counts
    real = Counter(b.level for b in ds.forest.all_blocks())
    padded_work = sum(ds_counts[l] * FULL_CAVITY["nranks"] * 2**l for l in ds_counts)
    real_work = sum(real[l] * 2**l for l in ds_counts)
    say(f"[device_sharded] padded stacks {json.dumps(ds_counts)} a rank against real blocks per level "
        f"{json.dumps(dict(sorted(real.items())))}: the stencils step {padded_work} block-substeps a coarse step "
        f"for {real_work} real ones ({padded_work / real_work - 1:.1%} padding)")
    ds_maps = ds_fn.halo_step_objects()
    say(f"[device_sharded] rank maps after the last AMR event: {len(ds_maps)} distinct halo steps, "
        f"{map_bytes(ds_maps) / 1e9:.4f} GB of maps (8 bytes a cell)")
    c0 = ds.comm.stats.summary()
    ds_host = []
    ds_rows, ds_busy_ms, ds_wall_ms = device_profile(lambda: ds.advance(2), ds_host)
    c1 = ds.comm.stats.summary()
    ds_groups, ds_group_ms = rank_groups(ds_rows)
    say(f"[device_sharded] profile of 2 steady coarse steps: device busy {ds_busy_ms:.3f} ms of "
        f"{ds_wall_ms:.3f} ms wall, idle share {1 - ds_busy_ms / ds_wall_ms:.1%}, {sum(ds_groups.values())} device "
        f"operations (fills then stencils: busy 30.675-30.691 ms, idle 45.5-47.3 %, 1,539 operations)")
    for name, ms, count in ds_rows[:14]:
        say(f"  {ms:9.3f} ms {ms / ds_busy_ms:6.1%} x{count:<5d} {name[:110]}")
    for key in sorted(ds_groups):
        say(f"[device_sharded] {key}: {ds_groups[key]} launches, {ds_group_ms[key]:.3f} ms in 2 steady coarse steps")
    ds_halo_seen = ds_groups["halo route"] + ds_groups["halo route (slot list)"]
    say(f"[device_sharded] the superstep counts {2 * ds_fn.fill_segments} fill launches, {2 * ds_fn.halo_steps} "
        f"halo-route launches and {2 * ds_fn.payload_copies} payload copies in 2 coarse steps; the profile holds "
        f"{ds_groups['fill']} fills and {ds_halo_seen} halo-route launches")
    for label, host, wall in (("fused_sharded", fs_host, fs_wall_ms), ("device_sharded", ds_host, ds_wall_ms)):
        say(f"[{label}] host operators of the profile by self CPU time ({sum(r[1] for r in host):.3f} ms "
            f"in all, {wall:.3f} ms wall):")
        for name, ms, count in host[:10]:
            say(f"  {ms:9.3f} ms x{count:<5d} {name[:100]}")
    ds_nsub2 = 2 * ds_progs.nsub
    say(f"[device_sharded] DeviceComm during the profile: {(c1['p2p_bytes'] - c0['p2p_bytes']) / ds_nsub2:.0f} bytes, "
        f"{(c1['p2p_messages'] - c0['p2p_messages']) / ds_nsub2:.1f} messages per substep")
    banned = [r[0] for r in ds_rows if re.search(r"scatter|index_put", r[0], re.IGNORECASE)]
    check(not banned, f"no index scatter in the steady device_sharded step: {banned}")
    check(ds_fn.fill_segments == 0 and ds_groups["fill"] == 0, "no fill launch in the steady device_sharded step")
    check(ds_halo_seen == 2 * ds_fn.halo_steps,
          f"halo-route launches {ds_halo_seen} == the superstep's count {2 * ds_fn.halo_steps}")
    del ds, ds_progs, ds_fn

    # the tracers: the full cavity in fused_sharded with 16,384 tracers
    tcfg = LidDrivenCavityConfig(stepping_mode="fused_sharded", kernel_backend="cuda",
                                 particles=ParticlesConfig(**TRACERS_FULL), **FULL_CAVITY)
    reset_launches()
    t_tr = time.perf_counter()
    ts = AMRLBM(tcfg)
    ids0 = all_particles(ts.forest)["id"]
    check(ids0.size == 64 * TRACERS_FULL["per_block"], f"{ids0.size} tracers seeded")
    stage_s, moved_b, step_s = [], [], []
    for i in range(8):
        sec0, bytes0 = ts.data_stats["particles"].seconds, dict(ts.particle_transfer_bytes)
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        ts.advance(1)
        step_s.append(time.perf_counter() - t0)
        stage_s.append(ts.data_stats["particles"].seconds - sec0)
        moved_b.append({k: ts.particle_transfer_bytes[k] - bytes0[k] for k in bytes0})
        if (i + 1) % 4 == 0:
            ts.adapt()
    ids1 = all_particles(ts.forest)["id"]
    check(ts.total_particles() == ids0.size, "tracer count conserved")
    check(np.array_equal(np.sort(ids1), np.sort(ids0)), "tracer id set conserved")
    tracer_launches = launch_counts()
    say(f"[tracers] fused_sharded, {ids0.size} tracers ({TRACERS_FULL}), 8 coarse steps with AMR every 4: "
        f"{time.perf_counter() - t_tr:.2f} s; blocks per level after: {json.dumps(blocks_per_level(ts))}")
    say("[tracers] coarse step wall times (s):", json.dumps([round(t, 4) for t in step_s]))
    say("[tracers] particles stage seconds per coarse step:", json.dumps([round(t, 4) for t in stage_s]))
    say("[tracers] h2d/d2h bytes per tracer step:", json.dumps([[b["h2d"], b["d2h"]] for b in moved_b]))
    say(f"[tracers] advected {ts.particles_advected}, moved {ts.particles_moved} across blocks; "
        f"count and id set conserved; kernel launches {json.dumps(tracer_launches)}")
    del ts

    # -- 2b. serving: four full-cavity jobs batched by SimulationService ---------
    def serving_cfg(mode: str, over: dict):
        return LidDrivenCavityConfig(stepping_mode=mode, kernel_backend="cuda", **{**FULL_CAVITY, **over})

    def interiors(s) -> dict:
        s.materialize_host()
        return {b.bid: s.spec.interior(b.data["pdf"]).copy() for b in s.forest.all_blocks()}

    def updates_per_coarse_step(s) -> int:
        return sum(n * int(np.prod(s.cfg.cells_per_block)) * 2**l for l, n in blocks_per_level(s).items())

    # the fourth member must not refine at the first AMR event, so that the
    # batch splits there: lower its lid until it does not
    members = [dict(m) for m in SERVING_MEMBERS]
    for _ in range(8):
        probe = AMRLBM(serving_cfg("fused", members[3]))
        probe.advance(SERVING_AMR_INTERVAL)
        probe.adapt()
        refined = probe.forest.levels_in_use() != [0]
        del probe
        if not refined:
            break
        members[3]["u_lid"] = tuple(0.5 * c for c in members[3]["u_lid"])
    check(not refined, "a lid low enough that the fourth member does not refine at the first event")
    say(f"[serving] fourth member's lid {members[3]['u_lid']} (listed {SERVING_MEMBERS[3]['u_lid']}): "
        f"it does not refine at the first AMR event")

    # solo references: each member as a solo fused run of its config; only
    # host copies of the interiors are kept
    solo_refs = []
    for i, over in enumerate(members):
        s = AMRLBM(serving_cfg("fused", over))
        forests, step_s, amr_s = [], [], []
        for k in range(SERVING_STEPS):
            torch.cuda.synchronize()
            t0 = time.perf_counter()
            s.advance(1)
            step_s.append(time.perf_counter() - t0)
            if (k + 1) % SERVING_AMR_INTERVAL == 0:
                t0 = time.perf_counter()
                s.adapt()
                amr_s.append(time.perf_counter() - t0)
                forests.append(forest_of(s))
        solo_refs.append(dict(forests=forests, interiors=interiors(s)))
        say(f"[serving] solo fused reference {i + 1} {json.dumps(over)}: blocks per level after each event "
            f"{[dict(sorted(Counter(l for _b, l, _o in f).items())) for f in forests]}; coarse step wall times (s) "
            f"{json.dumps([round(t, 4) for t in step_s])}; AMR events (s) {json.dumps([round(t, 3) for t in amr_s])}")
        del s

    # the service: four arena jobs on the kernels, AMR every 4 coarse steps
    torch.cuda.synchronize()
    mem0 = torch.cuda.memory_allocated()
    torch.cuda.reset_peak_memory_stats()
    reset_launches()
    t_srv = time.perf_counter()
    svc = SimulationService()
    jobs = [svc.jobs[svc.submit(JobSpec(config=serving_cfg("arena", over), coarse_steps=SERVING_STEPS,
                                        amr_interval=SERVING_AMR_INTERVAL))] for over in members]
    check(all(j.sim.device.type == "cuda" for j in jobs), "the jobs run on the card")
    amr_event_s = []
    for job in jobs:  # time each member's AMR event
        def timed_adapt(*a, _adapt=job.sim.adapt, **k):
            torch.cuda.synchronize()
            t0 = time.perf_counter()
            out = _adapt(*a, **k)
            amr_event_s.append(time.perf_counter() - t0)
            return out

        job.sim.adapt = timed_adapt
    keys = {(topology_key(jobs[0].sim.forest), tuple(jobs[0].sim.forest.levels_in_use()))}
    svc._form_groups()  # the first round's groups, so that their transfer counters can be read around it
    rounds, member_forests, states_after_first = [], [[] for _ in jobs], None
    more = True
    while more:
        ens = [g.ensemble for g in svc._groups]
        moved0 = [(e.h2d_bytes, e.d2h_bytes) for e in ens]
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        more = svc.run_round()
        torch.cuda.synchronize()
        rounds.append(dict(seconds=round(time.perf_counter() - t0, 3), members=[e.size for e in ens],
                           h2d_bytes=sum(e.h2d_bytes - a for e, (a, _b) in zip(ens, moved0)),
                           d2h_bytes=sum(e.d2h_bytes - b for e, (_a, b) in zip(ens, moved0))))
        for i, job in enumerate(jobs):
            member_forests[i].append(forest_of(job.sim))
        if len(rounds) == 1:  # the state the second chunk steps from
            states_after_first = [export_state(job.sim) for job in jobs]
            keys |= {(topology_key(j.sim.forest), tuple(j.sim.forest.levels_in_use())) for j in jobs}
    serving_s = time.perf_counter() - t_srv
    serving_launches = launch_counts()
    serving_peak_gb = (torch.cuda.max_memory_allocated() - mem0) / 1e9
    summary = svc.summary()
    say(f"[serving] {len(jobs)} jobs x {SERVING_STEPS} coarse steps, AMR every {SERVING_AMR_INTERVAL}: "
        f"{serving_s:.2f} s in {len(rounds)} rounds; counters "
        f"{json.dumps({k: summary[k] for k in ('ensembles_formed', 'divergence_splits', 'batched_steps', 'solo_steps', 'compile_hits', 'compile_misses', 'programs')})}; "
        f"distinct (topology, level set) keys stepped: {len(keys)}")
    say("[serving] rounds (chunks):", json.dumps(rounds))
    say("[serving] AMR event wall times (s), member by member:", json.dumps([round(t, 3) for t in amr_event_s]))
    say(f"[serving] peak device memory: {serving_peak_gb:.3f} GB; kernel launches: {json.dumps(serving_launches)}")
    check(summary["jobs_completed"] == len(jobs) and all(j.step == SERVING_STEPS for j in jobs), "every job ran to its end")
    check(summary["ensembles_formed"] == 1, "the four jobs formed one ensemble")
    check(summary["divergence_splits"] >= 1, "the batch split at an AMR event")
    check(summary["compile_misses"] <= len(keys), "one program per distinct (topology, level set) key at most")
    check(serving_launches["lbm_stream_collide[members]"] == serving_launches["lbm_stream_collide"] > 0,
          "every stencil launch of the service went through the member axis")
    check(serving_launches["lbm_halo_fill"] == 0, "the service launched no separate fill")
    check(serving_launches["lbm_stream_collide[halo+members]"] == serving_launches["lbm_stream_collide[halo]"] > 0,
          "every halo-route launch of the service went through the member axis")
    for i, job in enumerate(jobs):
        check(member_forests[i] == solo_refs[i]["forests"], f"member {i + 1} grew its solo run's forest at every event")
        got, want = interiors(job.sim), solo_refs[i]["interiors"]
        check(got.keys() == want.keys(), f"member {i + 1}: the solo run's blocks")
        for bid, arr in got.items():
            check(np.array_equal(arr, want[bid]), f"member {i + 1} block {bid:#x}: interior bitwise equal to its solo run's")
    say(f"[serving] every member grew its solo fused run's forest at both AMR events and ended with every block "
        f"interior bitwise equal to it ({sum(len(r['interiors']) for r in solo_refs)} blocks)")
    del svc, jobs, solo_refs

    # steady rates, from the state after the first event: the batch's groups
    # (the members that share a forest) against the four solo runs, two
    # steady coarse steps each, all from the same state
    groups = {}
    for i, st in enumerate(states_after_first):
        groups.setdefault(tuple(sorted((bid, lv) for bid, (lv, _o, _a) in st["blocks"].items())), []).append(i)
    big = max(groups.values(), key=len)
    check(len(big) >= 2, f"members share a forest after the first event: {list(groups.values())}")

    def from_state(i, mode):
        s = AMRLBM(serving_cfg(mode, members[i]))
        load_state(s, states_after_first[i])
        return s

    # the program a group builds once, against each member's own superstep
    # build, and each first step (upload included)
    batched_s = batched_member_steps = batched_updates = 0
    build_s, first_s = {}, {}
    for idx in groups.values():
        sims = [from_state(i, "arena") for i in idx]
        e = Ensemble(sims)
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        e._program()  # ghost plans of every pattern, fill tables, device masks
        t1 = time.perf_counter()
        e.advance(1)  # uploads the member stacks
        build_s["batched", tuple(idx)], first_s["batched", tuple(idx)] = t1 - t0, time.perf_counter() - t1
        t0 = time.perf_counter()
        e.advance(2)  # ends in a device synchronize
        batched_s += time.perf_counter() - t0
        batched_member_steps += 2 * len(idx)
        batched_updates += 2 * len(idx) * updates_per_coarse_step(sims[0])
        if idx is big:
            big_forest = blocks_per_level(sims[0])
            reset_launches()
            e.advance(1)
            batched_step_launches = launch_counts()
            b_rows, b_busy, b_wall = device_profile(lambda: e.advance(2), events=True)
            b_ops = aten_ops(lambda: e.advance(2))
            batched_halo_steps = e._program()[0].halo_steps
        del e, sims
    solo_s = solo_updates = 0
    for i in range(len(members)):
        s = from_state(i, "fused")
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        s.engine._fused_program()
        t1 = time.perf_counter()
        s.advance(1)  # uploads the buffers
        build_s["solo", i], first_s["solo", i] = t1 - t0, time.perf_counter() - t1
        t0 = time.perf_counter()
        s.advance(2)
        solo_s += time.perf_counter() - t0
        solo_updates += 2 * updates_per_coarse_step(s)
        if i == big[0]:
            reset_launches()
            s.advance(1)
            solo_step_launches = launch_counts()
            s_rows, s_busy, s_wall = device_profile(lambda: s.advance(2), events=True)
        del s
    del states_after_first
    say("[serving] program builds after the first event (s), per batched group and per solo member:",
        json.dumps({f"{k[0]} {k[1]}": round(v, 3) for k, v in build_s.items()}),
        f"(batched {sum(v for k, v in build_s.items() if k[0] == 'batched'):.3f} s in all, solo "
        f"{sum(v for k, v in build_s.items() if k[0] == 'solo'):.3f} s); first coarse step with its upload (s):",
        json.dumps({f"{k[0]} {k[1]}": round(v, 3) for k, v in first_s.items()}))
    step_keys = ("lbm_stream_collide", "lbm_stream_collide[halo]")
    # all four members on the roots (before the first event): one batched
    # coarse step of M = 4 against one solo step
    roots = [AMRLBM(serving_cfg("arena", over)) for over in members]
    e = Ensemble(roots)
    e.advance(1)
    reset_launches()
    e.advance(1)
    roots_batched = launch_counts()
    del e, roots
    s = AMRLBM(serving_cfg("fused", members[0]))
    s.advance(1)
    reset_launches()
    s.advance(1)
    roots_solo = launch_counts()
    del s
    say(f"[serving] launches of one coarse step on the 64 roots: batched ({len(members)} members) "
        f"{json.dumps({k: roots_batched[k] for k in step_keys})}, one solo fused member "
        f"{json.dumps({k: roots_solo[k] for k in step_keys})}")
    check(all(roots_batched[k] == roots_solo[k] > 0 for k in step_keys)
          and roots_batched["lbm_halo_fill"] == roots_solo["lbm_halo_fill"] == 0,
          "a batched coarse step of all members launches what one solo fused coarse step launches")
    say(f"[serving] launches of one steady coarse step on the forest {json.dumps(big_forest)}: batched "
        f"({len(big)} members) {json.dumps({k: batched_step_launches[k] for k in step_keys})}, one solo fused member "
        f"{json.dumps({k: solo_step_launches[k] for k in step_keys})}")
    check(all(batched_step_launches[k] == solo_step_launches[k] > 0 for k in step_keys),
          "a batched coarse step launches what one solo fused coarse step launches")
    check(batched_step_launches["lbm_halo_fill"] == 0
          and batched_step_launches["lbm_stream_collide[halo+members]"] == batched_halo_steps,
          "zero fill launches and one halo launch per filled active level a substep")
    batched_rate = batched_member_steps / batched_s
    solo_rate = 2 * len(members) / solo_s
    say(f"[serving] steady member-coarse-steps/s from the state after the first event (groups "
        f"{[len(v) for v in groups.values()]}): batched {batched_rate:.3f} ({batched_updates / batched_s / 1e6:.1f} MLUPS), "
        f"the {len(members)} solo fused runs back to back {solo_rate:.3f} ({solo_updates / solo_s / 1e6:.1f} MLUPS), "
        f"ratio {batched_rate / solo_rate:.3f}")
    def device_time(rows_, busy, wall):
        if rows_ is None:
            return f"{busy:.3f} ms from first launch to last end by CUDA events (no profile) of {wall:.3f} ms wall"
        return f"device busy {busy:.3f} ms of {wall:.3f} ms wall, idle share {1 - busy / wall:.1%}"

    say(f"[serving] profile of 2 steady batched coarse steps ({len(big)} members): {device_time(b_rows, b_busy, b_wall)}; "
        f"one solo member: {device_time(s_rows, s_busy, s_wall)}"
        + (f"; device time ratio {b_busy / s_busy:.3f}" if (b_rows is None) == (s_rows is None) else ""))
    for label, rows_, busy in (("batched", b_rows, b_busy), ("solo", s_rows, s_busy)):
        if rows_ is None:
            continue
        say(f"[serving] {label}: {sum(r[2] for r in rows_)} kernels in the profile "
            f"(the launch counts say {2 * sum(batched_step_launches[k] for k in step_keys)})")
        for name, ms, count in rows_[:8]:
            say(f"  {ms:9.3f} ms {ms / busy:6.1%} x{count:<5d} {name[:110]}")
    banned = [name for name in [*(r[0] for r in b_rows or ()), *b_ops]
              if re.search(r"index|gather|scatter|cat", name, re.IGNORECASE)]
    say(f"[serving] PyTorch operators of 2 steady batched coarse steps: {json.dumps(dict(b_ops))}")
    check(not banned, f"no index gather, scatter or cat in the steady batched step: {banned}")

    # elastic resize at the cross-check's depth: fused_sharded resized 4 -> 2
    # at step 4 (in memory, then through a disk checkpoint) continues to step
    # 8 bitwise equal to an uninterrupted fused run
    e_ref = AMRLBM(LidDrivenCavityConfig(stepping_mode="fused", kernel_backend="cuda", **CROSS_CHECK))
    e_ref.run(8, amr_interval=4)
    e_want, e_forest = interiors(e_ref), {(b.bid, b.level) for b in e_ref.forest.all_blocks()}
    del e_ref
    for mode, via_disk, over in (("fused_sharded", False, {}), ("fused_sharded", True, {}),
                                 ("device_sharded", False, dict(rank_devices=SHARED_CARD))):
        s = AMRLBM(LidDrivenCavityConfig(stepping_mode=mode, kernel_backend="cuda", **CROSS_CHECK, **over))
        s.run(4, amr_interval=4)
        with tempfile.TemporaryDirectory() as tmp:
            report = resize_ranks(s, 2, checkpoint_dir=Path(tmp) / "ckpt" if via_disk else None)
        check(report.new_nranks == 2 == s.cfg.nranks and report.via_disk == via_disk, f"resized 4 -> 2: {report}")
        s.run(4, amr_interval=4)
        check(s.amr_cycles >= 1 and {(b.bid, b.level) for b in s.forest.all_blocks()} == e_forest,
              "the resized run grew the fused run's forest")
        got = interiors(s)
        check(all(np.array_equal(arr, e_want[bid]) for bid, arr in got.items()),
              "the resized run's interiors are bitwise the fused run's")
        if mode == "device_sharded":
            check(s.engine.rank_devices == (torch.device("cuda:0"),) * 2 and hasattr(s.comm, "ppermute"),
                  "the resized device_sharded run keeps its DeviceComm and takes the first 2 rank devices")
        say(f"[serving] elastic: {mode} resized 4 -> 2 at step 4 ({'through a disk checkpoint' if via_disk else 'in memory'}, "
            f"{report.seconds:.3f} s, rebalanced {report.rebalanced}) ends step 8 with all {len(got)} block interiors "
            f"bitwise equal to an uninterrupted fused run")
        del s
    del e_want

    # -- 2c. analysis and telemetry at the full cavity's width ------------------
    t_phase = time.perf_counter()
    sys.path.insert(0, str(ROOT / "tools"))
    from trace_report import PHASES, check_trace

    tracer = telemetry.get_tracer()
    capacity0 = tracer.capacity
    budgets = load_config(ROOT).section("retrace")["budgets"]
    reset_launches()

    # (b) the protocol verifier on the plans the fused and fused_sharded runs
    # held after each AMR event: events 1 and 2 were verified in phase 2,
    # event 3's plans were built by phase 2's profiles
    for mode, run_ in (("fused", sim), ("fused_sharded", fs)):
        t0 = time.perf_counter()
        protocol_at[mode].append((3, verify_engine_plans(run_), time.perf_counter() - t0))
        for event, findings, seconds in protocol_at[mode]:
            for f in findings[:5]:
                say("  " + render(f)[:300])
            check(not findings, f"[{mode}] protocol findings on the plans held after AMR event {event}")
        check([e for e, _, _ in protocol_at[mode]] == [1, 2, 3], f"[{mode}] plans verified at every AMR event")
        say(f"[analysis] protocol: {mode}'s plans held after AMR events 1, 2, 3 ({run_.forest.num_blocks()} "
            f"blocks after event 3): 0 findings; verified in "
            f"{', '.join(f'{sec:.3f}' for _, _, sec in protocol_at[mode])} s")

    def canonical(mode: str, **over):
        """The canonical build scenario at the full cavity's width under the
        sentinel: advance(2), one executed adapt(force_rebalance=True),
        advance(2); then a warm advance(2) that must build nothing."""
        t0 = time.perf_counter()
        with RetraceSentinel() as builds:
            run_ = AMRLBM(LidDrivenCavityConfig(stepping_mode=mode, kernel_backend="cuda", **FULL_CAVITY, **over))
            run_.advance(2)
            report_ = run_.adapt(force_rebalance=True)
            check(report_.executed, f"[{mode}] the canonical AMR event executes")
            run_.advance(2)
        with RetraceSentinel() as warm:
            run_.advance(2)
        over_budget = budget_findings(mode, builds.counts, budgets[mode])
        say(f"[analysis] builds of {mode} (advance 2, AMR event, advance 2; {run_.forest.num_blocks()} blocks after "
            f"the event): {json.dumps(builds.counts)}, total {builds.total()} against a budget of {budgets[mode]}; "
            f"warm advance(2): {warm.total()} builds; {time.perf_counter() - t0:.2f} s")
        check(not over_budget, "; ".join(render(f) for f in over_budget))
        check(warm.total() == 0, f"[{mode}] a warm advance builds nothing: {warm.counts}")
        return run_, report_

    # (a) + (c): fused_sharded runs traced; the sentinel leaves the tracer as is
    telemetry.configure(enabled=True, capacity=1 << 16)
    tracer.reset()
    tfs, t_report = canonical("fused_sharded")
    with tempfile.TemporaryDirectory() as tmp:
        trace = json.loads(telemetry.export.write_chrome_trace(Path(tmp) / "fused_sharded.trace.json").read_text())
    errors = check_trace(trace, require_substep_phases=True)
    check(errors == [], f"the traced fused_sharded run's trace is valid: {errors[:5]}")
    substep_names = {ev["name"] for ev in trace["traceEvents"] if ev.get("cat") == "substep"}
    check(set(PHASES) <= substep_names, f"all four substep phases in the trace: {sorted(substep_names)}")
    check(any(ev["name"] == "amr.event" and ev["ph"] == "i" for ev in trace["traceEvents"]), "an amr.event instant")
    stage_sums = telemetry.export.stage_seconds(tracer, cat="stage")
    for stage in ("halo", "step", "fused"):
        check(stage_sums.get(stage, 0.0) == tfs.data_stats[stage].seconds,
              f"stage spans of {stage!r} sum exactly to data_stats: {stage_sums.get(stage)} vs "
              f"{tfs.data_stats[stage].seconds}")
    amr_sums = telemetry.export.stage_seconds(tracer, cat="amr")
    for stage in ("refine", "proxy", "balance", "migrate"):
        check(amr_sums[stage] == t_report.stages[stage].seconds, f"the AMR report's {stage} equals its span")
    rings = tracer.buffer_stats()
    check(all(r["entries"] <= r["capacity"] and r["evicted"] == 0 for r in rings.values()),
          f"every ring within its capacity: {rings}")
    say(f"[analysis] telemetry: traced fused_sharded trace valid ({len(trace['traceEvents'])} events, phases "
        f"{sorted(substep_names)}, an amr.event); stage spans = data_stats exactly "
        f"({', '.join(f'{k} {stage_sums.get(k, 0.0):.6f} s' for k in ('halo', 'step', 'fused'))}); the AMR report's "
        f"4 stages = their spans exactly; rings {max(r['entries'] for r in rings.values())} of "
        f"{tracer.capacity} records at most, none evicted")

    # (d) the cost of telemetry: steady fused_sharded coarse steps/s with
    # telemetry on and off, in alternating turns (on/off, then off/on, so a
    # drift of the host's speed falls on both modes alike). The ratio of the
    # medians is resolved only where the two modes' interquartile ranges do
    # not overlap.
    turns, steps_a_turn = 8, 32
    rates = {True: [], False: []}
    for turn in range(turns):
        for enabled in ((True, False) if turn % 2 == 0 else (False, True)):
            telemetry.configure(enabled=enabled)
            tracer.reset()
            torch.cuda.synchronize()
            t0 = time.perf_counter()
            tfs.advance(steps_a_turn)  # ends in a device synchronize
            rates[enabled].append(steps_a_turn / (time.perf_counter() - t0))
    telemetry.configure(enabled=False)
    tracer.reset()
    q = {k: [float(np.percentile(v, p)) for p in (25, 50, 75)] for k, v in rates.items()}
    separated = q[True][2] < q[False][0] or q[False][2] < q[True][0]
    say(f"[analysis] telemetry cost, steady fused_sharded, {turns} turns of {steps_a_turn} coarse steps each way: "
        f"on {json.dumps([round(r, 3) for r in rates[True]])}, off {json.dumps([round(r, 3) for r in rates[False]])} "
        f"coarse steps/s; quartiles on {', '.join(f'{x:.3f}' for x in q[True])}, off "
        f"{', '.join(f'{x:.3f}' for x in q[False])}; on/off of the medians {q[True][1] / q[False][1]:.3f}, "
        + ("resolved: the interquartile ranges do not overlap" if separated
           else "unresolved: the interquartile ranges overlap"))
    del tfs

    # (a) fused and device_sharded, untraced
    for mode, over in (("fused", {}), ("device_sharded", dict(rank_devices=SHARED_CARD))):
        run_, _ = canonical(mode, **over)
        del run_

    # (e) the trace twin, on the card, into a temporary path
    spec = importlib.util.spec_from_file_location("trace_twin", ROOT / "examples" / "trace_fused_sharded_torch.py")
    twin = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(twin)
    with tempfile.TemporaryDirectory() as tmp:
        twin_path = twin.main(["--out", str(Path(tmp) / "twin.trace.json")])
        twin_trace = json.loads(Path(twin_path).read_text())
    telemetry.configure(enabled=False, capacity=capacity0)
    tracer.reset()
    errors = check_trace(twin_trace, require_substep_phases=True)
    check(errors == [], f"the trace twin's trace is valid: {errors[:5]}")
    say(f"[analysis] examples/trace_fused_sharded_torch.py main on the card: trace valid, "
        f"{len(twin_trace['traceEvents'])} events")
    analysis_launches = launch_counts()
    for key in ("lbm_stream_collide", "lbm_stream_collide[slots]", "lbm_stream_collide[halo]",
                "lbm_stream_collide[halo+slots]"):
        check(analysis_launches[key] > 0, f"{key} launched in phase 2c")
    check(analysis_launches["lbm_halo_fill"] == 0, "no separate fill launched in phase 2c")
    say(f"[analysis] kernel launches in phase 2c: {json.dumps(analysis_launches)}")
    say(f"[analysis] phase 2c wall time {time.perf_counter() - t_phase:.2f} s (plus phase 2's protocol checks, "
        f"{sum(sec for runs_ in protocol_at.values() for _, _, sec in runs_[:2]):.3f} s)")

    lm_lines = []
    if lm:
        # -- 3. the LM scaffold's serving path at full width ----------------------
        lm_lines.append({"lm_serve": lm_serving_phase()})
        # -- 3b. the moe, ssm, hybrid and audio families at full width -----------
        lm_lines.append({"lm_families": lm_families_phase()})
        # -- 4. the LM training path at full width --------------------------------
        lm_lines.append({"lm_train": lm_train_phase()})
        # -- 5. the LM distribution layer on a one-rank NCCL mesh -----------------
        lm_lines.append({"lm_dist": lm_dist_phase()})

    # -- 6. kernels against their plain versions, main-path shapes ---------------
    gc.collect()  # reference cycles of earlier phases' models
    torch.cuda.empty_cache()
    torch.cuda.reset_peak_memory_stats()
    mem6 = torch.cuda.memory_allocated()
    say(f"phase 6 starts with {mem6 / 1e9:.3f} GB allocated on the card")
    lattice = sim.spec.lattice
    kw_l = {l: dict(omega=omega_for_level(cfg.omega, l), lattice=lattice,
                    u_wall=cfg.u_lid, collision=cfg.collision) for l in levels}
    bufs = [res.fetch(l, "pdf") for l in levels]
    masks = [res.fetch(l, "mask") for l in levels]
    # the first 64 blocks, finest level first (the moving fluid under the lid)
    f64b = torch.cat(bufs[::-1])[:64].contiguous()
    m64b = torch.cat(masks[::-1])[:64].contiguous()
    check(f64b.shape == (64, 19, 34, 34, 34), f"main-path stack shape {tuple(f64b.shape)}")
    kw = kw_l[lmax]
    got = lbm_stream_collide(f64b, m64b, **kw)
    want = stream_collide_ref(f64b, m64b, **kw)
    torch.cuda.synchronize()
    k1_err = max_err(got, want)
    torch.testing.assert_close(got, want, **TOL[torch.float32])
    del got, want
    k1_ms = time_ms(lambda: lbm_stream_collide(f64b, m64b, **kw), iters=50)
    k1_plain_ms = time_ms(lambda: stream_collide_ref(f64b, m64b, **kw), iters=5, warmup=1)
    k1_bound_ms, k1_by = stencil_bound_ms(f64b, m64b, cfg.collision)
    say(f"lbm_stream_collide D3Q19 TRT f32 B=64 34^3 (real cavity state, finest level first): max |err| {k1_err:.3e}, "
        f"kernel {k1_ms:.4f} ms, plain {k1_plain_ms:.4f} ms, bound {k1_bound_ms:.4f} ms ({k1_by}), "
        f"{k1_bound_ms / k1_ms:.1%} of bound")
    del f64b, m64b

    # the halo step: real compiled fills of the cavity (every level of the
    # pattern that activates all levels), from their sources
    fills = pattern_fills[lmax]  # the pattern that activates every level
    tables = {l: fill_tables(f, index, "cuda") for l, f in fills.items()}
    check({t.kind for ts in tables.values() for t in ts} == {"same", "coarse", "fine"},
          "the cavity's fills hold every segment kind")

    def run_fill(fill_fn, l, work):
        for t in tables[l]:
            fill_fn(work[index[l]], work[t.src], t.kind, t.dst_slot, t.dst_cell, t.src_slot, t.src_cell)

    for l in levels:  # every level's fill, kernel against plain, bitwise in practice
        got, want = list(bufs), list(bufs)
        got[index[l]], want[index[l]] = bufs[index[l]].clone(), bufs[index[l]].clone()
        run_fill(lbm_halo_fill, l, got)
        run_fill(halo_fill_ref, l, want)
        torch.cuda.synchronize()
        err = max_err(got[index[l]], want[index[l]])
        torch.testing.assert_close(got[index[l]], want[index[l]], **TOL[torch.float32])
        say(f"lbm_halo_fill level {l}: segments "
            f"{[(t.kind, t.dst_slot.numel()) for t in tables[l]]}: max |err| {err:.3e}")
    del got, want

    i2 = index[lmax]
    f_fine, m_fine = bufs[i2], masks[i2]
    B2 = f_fine.shape[0]
    rows2 = fills[lmax].num_cells
    # the whole-stack route's launch groups: 8 consecutive blocks of the
    # level's stack, whole octets where the stack is octet-aligned
    nb_fused = face_neighbours(fills[lmax], tuple(bufs[i2].shape[2:]))
    fused_octets = (cube_groups(range(B2), nb_fused), cube_groups(neighbour_order(range(B2), nb_fused), nb_fused))
    say(f"fused level {lmax}: whole octets in its {-(-B2 // 8)} launch groups {fused_octets[0]} in block order, "
        f"{fused_octets[1]} in neighbour order")
    work = list(bufs)
    work[i2] = f_fine.clone()  # the fill writes its destination's ghost ring in place

    def halo_step():
        run_fill(lbm_halo_fill, lmax, work)
        return lbm_stream_collide(work[i2], m_fine, **kw)

    coeffs = collision_coeffs(kw["omega"], lattice=lattice, u_wall=cfg.u_lid,
                              collision=cfg.collision, dtype=np.float32)
    plain_work = list(bufs)

    def plain_halo_step():
        plain_work[i2] = f_fine.clone()
        run_fill(halo_fill_ref, lmax, plain_work)
        return stream_collide_coeffs(plain_work[i2], m_fine, coeffs, lattice=lattice, collision=cfg.collision)

    got, want = halo_step(), plain_halo_step()
    torch.cuda.synchronize()
    k2_err = max_err(got, want)
    torch.testing.assert_close(got, want, **TOL[torch.float32])
    del got
    fill_ms = time_ms(lambda: run_fill(lbm_halo_fill, lmax, work), iters=30)
    sten2_ms = time_ms(lambda: lbm_stream_collide(work[i2], m_fine, **kw), iters=30)
    k2_ms = time_ms(halo_step, iters=30)
    k2_plain_ms = time_ms(plain_halo_step, iters=3, warmup=1)
    # bounds, each byte once: the fill alone reads its distinct source cells
    # and writes its rows; the halo step (fill + stencil, one function of the
    # pre-step buffers) reads the level's buffer except the ghost rows the
    # fill overwrites, the mask, the distinct source cells of other levels
    # and the index tables, and writes the stepped buffer
    cells2 = int(np.prod(f_fine.shape[2:]))
    row_bytes = lattice.Q * f_fine.element_size()
    tr = fill_traffic(tables[lmax], cells2)
    check(tr["rows"] == rows2, "the fill tables cover the merged fill")
    fbytes = (tr["rows"] + tr["src_own"] + tr["src_other"]) * row_bytes + tr["index_bytes"]
    fill_bound_ms = fbytes / HBM_BYTES_PER_S * 1e3
    sten2_bound_ms, _ = stencil_bound_ms(f_fine, m_fine, cfg.collision)
    k2_extra = (tr["src_other"] - tr["rows"]) * row_bytes + tr["index_bytes"]
    k2_bound_ms, k2_by = stencil_bound_ms(f_fine, m_fine, cfg.collision, extra_bytes=k2_extra)
    say(f"lbm_halo_fill level {lmax} rows by kind {json.dumps(tr['rows_by_kind'])}; distinct source cells: "
        f"{tr['src_own']} in the level's own buffer, {tr['src_other']} in other levels' "
        f"({tr['src_other'] / max(tr['rows'] - tr['rows_by_kind'].get('same', 0), 1):.3f} per coarse/fine row)")
    say(f"lbm_halo_fill level {lmax} from sources ({rows2} ghost rows, {len(tables[lmax])} launches): "
        f"{fill_ms:.4f} ms, bound {fill_bound_ms:.4f} ms ({fbytes / 1e9:.4f} GB), "
        f"{fill_bound_ms / fill_ms:.1%} of bound")
    say(f"lbm_stream_collide level {lmax} B={B2}: {sten2_ms:.4f} ms, bound {sten2_bound_ms:.4f} ms, "
        f"{sten2_bound_ms / sten2_ms:.1%} of bound")
    say(f"halo step level {lmax} (fill from sources + stencil), D3Q19 TRT f32 B={B2}: max |err| {k2_err:.3e}, "
        f"kernels {k2_ms:.4f} ms, plain {k2_plain_ms:.4f} ms, bound {k2_bound_ms:.4f} ms ({k2_by}; "
        f"{k2_extra / 1e9:+.4f} GB beside the stencil's), {k2_bound_ms / k2_ms:.1%} of bound; "
        f"shares of their own bounds: fill {fill_bound_ms / fill_ms:.1%}, stencil {sten2_bound_ms / sten2_ms:.1%}")

    # the fill of the level split by destination class and segment kind,
    # each sub-table timed alone, against a Tensor.copy_ of the fill's
    # value bytes (the streaming yardstick)
    split = fill_classes(tables[lmax], tuple(f_fine.shape[2:]))
    split_ms = {key: time_ms(lambda t=t: lbm_halo_fill(work[i2], work[t.src], t.kind, t.dst_slot, t.dst_cell,
                                                         t.src_slot, t.src_cell), iters=30)
                for key, t in split.items()}
    split_total = sum(split_ms.values())
    z_share = sum(ms for (c, _k), ms in split_ms.items() if c == "z-face") / split_total
    copy_a = torch.empty(rows2 * lattice.Q, dtype=f_fine.dtype, device="cuda")
    copy_b = torch.empty_like(copy_a)
    copy_ms = time_ms(lambda: copy_b.copy_(copy_a), iters=30)
    copy_bytes = 2 * copy_a.numel() * copy_a.element_size()
    for (c, kind), ms in sorted(split_ms.items()):
        say(f"lbm_halo_fill level {lmax} sub-table {c}/{kind}: {split[c, kind].dst_slot.numel()} rows, {ms:.4f} ms "
            f"({ms / split_total:.1%})")
    say(f"lbm_halo_fill level {lmax}: sub-tables {split_total:.4f} ms in all against {fill_ms:.4f} ms for the whole "
        f"fill; z-face share {z_share:.1%}; Tensor.copy_ of the fill's values ({copy_bytes} bytes moved) "
        f"{copy_ms:.4f} ms, {copy_bytes / copy_ms / 1e9:.1f} TB/s")
    del copy_a, copy_b

    # the halo route (the main path's halo step): one launch reading each
    # ghost value from its source, bitwise the fill then the stencil
    hmap2 = halo_map(tables[lmax], m_fine, lattice.Q)
    srcs = tuple(bufs)
    out_h = torch.empty_like(f_fine)

    def halo_route():
        return lbm_stream_collide(f_fine, m_fine, halo=hmap2, sources=srcs, out=out_h, **kw)

    got = halo_route()
    fill_then = halo_step()
    torch.cuda.synchronize()
    kh_bitwise = max_err(got, fill_then)
    check(kh_bitwise == 0.0, f"the halo route equals the fill then the stencil bitwise ({kh_bitwise})")
    kh_err = max_err(got, want)
    torch.testing.assert_close(got, want, **TOL[torch.float32])
    del got, fill_then
    kh_ms = time_ms(halo_route, iters=30)
    say(f"lbm_stream_collide[halo] level {lmax} B={B2} D3Q19 TRT f32: max |err| {kh_bitwise:.1e} against the fill "
        f"then the stencil, {kh_err:.3e} against plain; kernel {kh_ms:.4f} ms, fill then stencil {k2_ms:.4f} ms, "
        f"plain {k2_plain_ms:.4f} ms, bound {k2_bound_ms:.4f} ms ({k2_by}), {k2_bound_ms / kh_ms:.1%} of bound")

    # every filled level's halo step of the pattern that activates all
    # levels: the route against the fill then the stencil, bitwise, timed
    per_level = {}
    for l in levels:
        if l not in fills:
            continue
        i = index[l]
        hm_l = hmap2 if l == lmax else halo_map(tables[l], masks[i], lattice.Q)
        out_l = torch.empty_like(bufs[i])
        work_l = list(bufs)
        work_l[i] = bufs[i].clone()

        def fill_then_stencil_l(l=l, i=i, work_l=work_l, out_l=out_l):
            run_fill(lbm_halo_fill, l, work_l)
            return lbm_stream_collide(work_l[i], masks[i], out=out_l, **kw_l[l])

        def route_l(i=i, hm_l=hm_l, out_l=out_l, l=l):
            return lbm_stream_collide(bufs[i], masks[i], halo=hm_l, sources=srcs, out=out_l, **kw_l[l])

        want_l = fill_then_stencil_l().clone()
        got_l = route_l()
        torch.cuda.synchronize()
        check(max_err(got_l, want_l) == 0.0, f"level {l}: the halo route equals the fill then the stencil bitwise")
        per_level[l] = dict(blocks=bufs[i].shape[0], rows={t.kind: t.dst_slot.numel() for t in tables[l]},
                            halo_ms=time_ms(route_l, iters=30), fill_then_stencil_ms=time_ms(fill_then_stencil_l, iters=30),
                            stencil_ms=time_ms(lambda i=i, l=l, out_l=out_l: lbm_stream_collide(
                                bufs[i], masks[i], out=out_l, **kw_l[l]), iters=30))
        # where the level has fine rows: the route through its fine segment
        # alone and through its other segments alone (the step of a part
        # of the fill, timed only), to see which rows its time goes to
        parts = {"fine": [t for t in tables[l] if t.kind == "fine"],
                 "same+coarse": [t for t in tables[l] if t.kind != "fine"]}
        if all(parts.values()):
            for name, ts in parts.items():
                hm_p = halo_map(tuple(ts), masks[i], lattice.Q)
                per_level[l][f"halo_{name}_only_ms"] = time_ms(
                    lambda i=i, l=l, hm_p=hm_p, out_l=out_l: lbm_stream_collide(
                        bufs[i], masks[i], halo=hm_p, sources=srcs, out=out_l, **kw_l[l]), iters=30)
                per_level[l][f"fill_{name}_only_ms"] = time_ms(
                    lambda ts=ts, l=l, work_l=work_l: [lbm_halo_fill(work_l[index[l]], work_l[t.src], t.kind,
                                                                     t.dst_slot, t.dst_cell, t.src_slot, t.src_cell)
                                                       for t in ts], iters=30)
            del hm_p
        del got_l, want_l, out_l, work_l
    for l, r in per_level.items():
        split_l = "".join(f"; {name} rows alone: route {r[f'halo_{name}_only_ms']:.4f} ms, fill "
                          f"{r[f'fill_{name}_only_ms']:.4f} ms" for name in ("fine", "same+coarse")
                          if f"halo_{name}_only_ms" in r)
        say(f"halo step level {l} ({r['blocks']} blocks, rows {json.dumps(r['rows'])}): route {r['halo_ms']:.4f} ms, "
            f"fill then stencil {r['fill_then_stencil_ms']:.4f} ms, stencil alone {r['stencil_ms']:.4f} ms; bitwise"
            + split_l)

    # the slab form once (the Pallas halo kernel's interface): same fill
    vals = _concat_vals(bufs, _lower_fill_gathers(fills[lmax], index, f_fine.device))
    entry, cell, valid = _pad_fill_layout(fills[lmax].dst_slot, fills[lmax].dst_cell, B2, f_fine.shape[2:])
    hv = vals[torch.as_tensor(entry, dtype=torch.long, device="cuda")].contiguous()
    cell_t, valid_t = torch.as_tensor(cell, device="cuda"), torch.as_tensor(valid, device="cuda")
    f_slab = f_fine.clone()
    got = lbm_stream_collide_halo(f_slab, m_fine, hv, cell_t, valid_t, **kw)
    torch.cuda.synchronize()
    slab_err = max_err(got, want)
    torch.testing.assert_close(got, want, **TOL[torch.float32])
    del got, want
    slab_ms = time_ms(lambda: lbm_stream_collide_halo(f_slab, m_fine, hv, cell_t, valid_t, **kw), iters=30)
    slab_bytes = hv.numel() * hv.element_size() + cell_t.numel() * 4 + valid_t.numel()
    slab_bound_ms, _ = stencil_bound_ms(f_fine, m_fine, cfg.collision, extra_bytes=slab_bytes)
    say(f"lbm_stream_collide_halo (slab form) level {lmax} B={B2} P={cell.shape[1]}: max |err| {slab_err:.3e}, "
        f"{slab_ms:.4f} ms, bound {slab_bound_ms:.4f} ms (bytes, with the slab), "
        f"{slab_bound_ms / slab_ms:.1%} of bound")
    del f_slab, hv, vals, work, plain_work

    # the rank-sharded routes, from the fused_sharded run's real state: the
    # stencil over a rank's boundary slot list at the finest level, and the
    # values fill of its largest inbound message segment
    fs_progs = fs.engine._programs()
    p_all = fs_progs.pattern[0]  # substep 0 activates every level
    fs_res = {r: fs.arenas.per_rank[r].device() for r in fs_progs.ranks}
    fs_pdfs = {r: tuple(fs_res[r].fetch(l, "pdf") for l in fs_progs.rank_levels[r]) for r in fs_progs.ranks}

    def boundary_slots(r):
        masks_r = {l: fs_res[r].fetch(l, "mask") for l in fs_progs.rank_levels[r]}
        return sorted(boundary_slot_sets(fs_progs.recvs[p_all][r], masks_r).get(lmax, ()))

    r_s = max(fs_progs.ranks, key=lambda r: len(boundary_slots(r)) if lmax in fs_progs.rank_levels[r] else -1)
    i_s = fs_progs.rank_levels[r_s].index(lmax)
    f_r, m_r = fs_pdfs[r_s][i_s], fs_res[r_s].fetch(lmax, "mask")
    slots_np = np.asarray(boundary_slots(r_s), dtype=np.int32)
    check(0 < slots_np.size < f_r.shape[0], f"rank {r_s} holds boundary and interior blocks at level {lmax}")
    slots_t = torch.as_tensor(slots_np, device="cuda")
    idx_t = slots_t.long()
    kw = kw_l[lmax]
    out_s = torch.zeros_like(f_r)
    lbm_stream_collide(f_r, m_r, slots=slots_t, out=out_s, **kw)
    whole = lbm_stream_collide(f_r, m_r, **kw)
    plain_step = make_stream_collide(backend="ref", **kw)
    plain_out = plain_step(f_r, m_r, slots=slots_t, out=torch.zeros_like(f_r))
    torch.cuda.synchronize()
    ks_bitwise = max_err(out_s[idx_t], whole[idx_t])
    check(ks_bitwise == 0.0, f"slot-list stencil equals the whole-stack kernel on its blocks ({ks_bitwise})")
    rest = torch.ones(f_r.shape[0], dtype=torch.bool, device="cuda")
    rest[idx_t] = False
    check(not out_s[rest].any(), "the slot-list stencil leaves unlisted blocks alone")
    ks_err = max_err(out_s[idx_t], plain_out[idx_t])
    torch.testing.assert_close(out_s[idx_t], plain_out[idx_t], **TOL[torch.float32])
    del whole, plain_out
    ks_ms = time_ms(lambda: lbm_stream_collide(f_r, m_r, slots=slots_t, out=out_s, **kw), iters=30)
    ks_plain_ms = time_ms(lambda: plain_step(f_r, m_r, slots=slots_t, out=out_s), iters=3, warmup=1)
    ks_bound_ms, ks_by = stencil_bound_ms(f_r[idx_t], m_r[idx_t], cfg.collision, extra_bytes=slots_t.numel() * 4)
    say(f"lbm_stream_collide[slots] rank {r_s} level {lmax}: {slots_np.size} boundary slots of {f_r.shape[0]} "
        f"blocks: max |err| {ks_bitwise:.1e} against the whole-stack kernel, {ks_err:.3e} against plain; "
        f"kernel {ks_ms:.4f} ms, plain {ks_plain_ms:.4f} ms, bound {ks_bound_ms:.4f} ms ({ks_by}), "
        f"{ks_bound_ms / ks_ms:.1%} of bound")

    # the largest inbound message segment of the pattern that activates all
    # levels, built by the sender's emit from the real state
    best = None
    for r in fs_progs.ranks:
        for m in fs_progs.recvs[p_all][r]:
            off = 0
            for dl, db, dc, n in m.scatter:
                if best is None or n > best[-1]:
                    best = (r, m, dl, db, dc, off, n)
                off += n
    r_v, m_v, dl_v, db_v, dc_v, off_v, n_v = best
    sends = fs_progs.sends[p_all][m_v.src_rank]
    payload = fs_progs.emits[p_all][m_v.src_rank](fs_pdfs[m_v.src_rank])[
        next(i for i, m in enumerate(sends) if m is m_v)]
    seg = payload[off_v: off_v + n_v]
    check(seg.is_contiguous() and seg.shape == (n_v, lattice.Q), f"message segment {tuple(seg.shape)}")
    ds_t = torch.as_tensor(np.asarray(db_v, np.int32), device="cuda")
    dc_t = torch.as_tensor(np.asarray(dc_v, np.int32), device="cuda")
    dst0 = fs_pdfs[r_v][fs_progs.rank_levels[r_v].index(dl_v)]
    got, want = dst0.clone(), dst0.clone()
    lbm_halo_fill(got, seg, "values", ds_t, dc_t)
    halo_fill_ref(want, seg, "values", ds_t, dc_t)
    torch.cuda.synchronize()
    kv_err = max_err(got, want)
    check(kv_err == 0.0, f"values fill equals the plain scatter bitwise ({kv_err})")
    ds_l, dc_l = ds_t.long(), dc_t.long()

    def library_values():
        got.view(got.shape[0], lattice.Q, -1).transpose(1, 2).index_put_((ds_l, dc_l), seg)

    library_values()
    torch.cuda.synchronize()
    check(max_err(got, want) == 0.0, "index_put_ computes the values fill's function")
    # each timed as the median of single launches, kernel, plain version and
    # index_put_ in turn: one launch takes about 20 us
    kv = median_ms({"kernel": lambda: lbm_halo_fill(got, seg, "values", ds_t, dc_t),
                    "plain": lambda: halo_fill_ref(got, seg, "values", ds_t, dc_t),
                    "index_put_": library_values}, n=50)
    kv_ms, kv_plain_ms, kv_library_ms = (kv[k][0] for k in ("kernel", "plain", "index_put_"))
    kv_bytes = 2 * seg.numel() * seg.element_size() + 2 * n_v * 4
    kv_bound_ms = kv_bytes / HBM_BYTES_PER_S * 1e3
    say(f"lbm_halo_fill[values] message {m_v.src_rank}->{r_v} segment to level {dl_v}: {n_v} rows of the "
        f"{m_v.num_cells}-row payload: max |err| {kv_err:.1e}; medians of 50 single launches in turn (quartiles): "
        + ", ".join(f"{k} {m:.4f} ms ({q1:.4f}-{q3:.4f})" for k, (m, q1, q3) in kv.items())
        + f"; bound {kv_bound_ms:.5f} ms ({kv_bytes} bytes), {kv_bound_ms / kv_ms:.1%} of bound, "
        f"kernel / index_put_ {kv_ms / kv_library_ms:.3f}")
    del got, want, payload, seg

    # the rank route: rank r_s's level-lmax halves of the pattern that
    # activates every level (each over its slot list in neighbour order, as
    # the programs launch it, reading its local rows and, in the boundary
    # half, the rows of the payloads the senders' emits build from the real
    # state), then its unsplit level (a full-length list in neighbour
    # order); each against the same work done by fills, then the stencil
    # (bitwise), as the factory-less absorb splits it: the interior half
    # runs every local fill and the boundary half the values fills alone;
    # against the route in block order (the halves' sorted lists, the
    # whole stack without a list; bitwise); against the plain version
    # (within TOL); and its byte bound
    recvs_s = fs_progs.recvs[p_all][r_s]
    payloads_s = []
    for m in recvs_s:
        sends_m = fs_progs.sends[p_all][m.src_rank]
        payloads_s.append(fs_progs.emits[p_all][m.src_rank](fs_pdfs[m.src_rank])[
            next(i for i, x in enumerate(sends_m) if x is m)])
    rl_s = fs_progs.rank_levels[r_s]
    idx_s = {l: i for i, l in enumerate(rl_s)}
    masks_s = {l: fs_res[r_s].fetch(l, "mask") for l in rl_s}
    fills_s, inbound_s = _rank_rows(recvs_s, fs_progs.plans[p_all].local.get(r_s), idx_s, masks_s, set(rl_s))
    check(lmax in fills_s and lmax in inbound_s, f"rank {r_s}'s level {lmax} has local and message rows")
    local_t = fill_tables(fills_s[lmax], idx_s, "cuda")
    msg_t = message_tables(inbound_s[lmax], len(rl_s), "cuda")
    hm_r = halo_map(local_t + msg_t, m_r, lattice.Q)
    hm_local = HaloMap(hm_r.cells, local_t, m_r)  # the interior half's view: local rows only
    srcs_r = (*fs_pdfs[r_s], *payloads_s)
    msg_segs = [(mi, off, n, torch.as_tensor(np.asarray(db, np.int32), device="cuda"),
                 torch.as_tensor(np.asarray(dc, np.int32), device="cuda"))
                for mi, db, dc, off, n in inbound_s[lmax]]
    work_r = list(fs_pdfs[r_s])
    work_r[i_s] = f_r.clone()  # the fills write their ghost cells in place, the same values each time
    out_route, out_fill = torch.empty_like(f_r), torch.empty_like(f_r)
    coeffs_r = collision_coeffs(kw["omega"], lattice=lattice, u_wall=cfg.u_lid, collision=cfg.collision,
                                dtype=np.float32)
    interior_np = np.setdiff1d(np.arange(f_r.shape[0], dtype=np.int32), slots_np)
    interior_t = torch.as_tensor(interior_np, device="cuda")
    # the route's lists in neighbour order: the split programs' own, and
    # the unsplit level's full-length list
    nb_s = face_neighbours(fills_s[lmax], tuple(f_r.shape[2:]))
    order_np = {"interior half": fs_progs.interiors[p_all][r_s].slot_lists[lmax],
                "boundary half": fs_progs.boundaries[p_all][r_s].slot_lists[lmax],
                "unsplit level": neighbour_order(range(f_r.shape[0]), nb_s)}
    for label, listed in (("interior half", interior_np), ("boundary half", slots_np)):
        check(np.array_equal(order_np[label], neighbour_order(listed, nb_s)),
              f"rank {r_s} level {lmax} {label}: the program's list is the neighbour order of its blocks")

    def rank_route(slots, payloads):
        if payloads:
            return lbm_stream_collide(f_r, m_r, halo=hm_r, sources=srcs_r, slots=slots, out=out_route, **kw)
        return lbm_stream_collide(f_r, m_r, halo=hm_local, sources=fs_pdfs[r_s], slots=slots, out=out_route, **kw)

    def rank_fills_then_stencil(slots, local, values):
        if local:
            for t in local_t:
                lbm_halo_fill(work_r[i_s], work_r[t.src], t.kind, t.dst_slot, t.dst_cell, t.src_slot, t.src_cell)
        if values:
            for mi, off, n, db_t, dc_t in msg_segs:
                lbm_halo_fill(work_r[i_s], payloads_s[mi][off: off + n], "values", db_t, dc_t)
        return lbm_stream_collide(work_r[i_s], m_r, slots=slots, out=out_fill, **kw)

    def plain_rank(slots, payloads):
        return halo_stream_collide_ref(f_r, m_r, coeffs_r, local_t + msg_t if payloads else local_t,
                                       srcs_r if payloads else fs_pdfs[r_s], lattice=lattice,
                                       collision=cfg.collision, slots=slots)

    # (label, slot list, listed blocks, reads payloads, the yardstick's local
    # fills, its values fills); the interior half runs first, so that the
    # boundary half's yardstick finds the local rows filled
    rank_cases = (("interior half", interior_t, interior_np, False, True, False),
                  ("boundary half", slots_t, slots_np, True, False, True),
                  ("unsplit level", None, np.arange(f_r.shape[0]), True, True, True))
    pay_segs = range(len(local_t), len(local_t) + len(msg_t))
    rank_rows = {}
    for label, slots_arg, listed, pay, loc, val in rank_cases:
        sel = torch.as_tensor(listed, dtype=torch.long, device="cuda")
        order_t = torch.as_tensor(order_np[label], device="cuda")
        route_fn = lambda s=order_t, p=pay: rank_route(s, p)  # noqa: E731
        block_fn = lambda s=slots_arg, p=pay: rank_route(s, p)  # noqa: E731
        yard_fn = lambda s=slots_arg, a=loc, b=val: rank_fills_then_stencil(s, a, b)  # noqa: E731
        got_block = block_fn()[sel].clone()
        got = route_fn()[sel].clone()
        want_f = yard_fn()[sel]
        torch.cuda.synchronize()
        bitwise = max_err(got, want_f)
        check(bitwise == 0.0, f"rank {r_s} level {lmax} {label}: the route equals the fills then the stencil "
                              f"bitwise ({bitwise})")
        check(max_err(got, got_block) == 0.0,
              f"rank {r_s} level {lmax} {label}: the route in neighbour order equals it in block order bitwise")
        plain = plain_rank(slots_arg, pay)[sel]
        err = max_err(got, plain)
        torch.testing.assert_close(got, plain, **TOL[torch.float32])
        del got, got_block, want_f, plain
        med = median_ms({"route": route_fn, "block order": block_fn, "fills then stencil": yard_fn}, n=30)
        octets = (cube_groups(listed, nb_s), cube_groups(order_np[label], nb_s), -(-len(listed) // 8))
        tiles = tile_histogram(payload_tile_counts(hm_r.cells, listed, pay_segs) if pay else np.zeros(0, np.int64))
        plain_ms_ = time_ms(lambda s=slots_arg, p=pay: plain_rank(s, p), iters=2, warmup=1)
        tr_r = route_traffic(local_t, msg_t if pay else (), listed, i_s, int(np.prod(f_r.shape[2:])))
        extra = ((tr_r["src_outside"] + tr_r["payload_rows"] - tr_r["rows"]) * lattice.Q * f_r.element_size()
                 + tr_r["index_bytes"])
        bound_ms_, by_ = stencil_bound_ms(f_r[sel], m_r[sel], cfg.collision, extra_bytes=extra)
        rank_rows[label] = dict(blocks=len(listed), ms=med["route"][0], block_order_ms=med["block order"][0],
                                fill_then_stencil_ms=med["fills then stencil"][0],
                                quartiles={k: v[1:] for k, v in med.items()}, plain_ms=plain_ms_, bound_ms=bound_ms_,
                                bound_by=by_, max_abs_err=err, max_abs_err_fill_then_stencil=bitwise,
                                whole_octet_groups=dict(zip(("block_order", "neighbour_order", "groups"), octets)),
                                payload_rows_per_tile=tiles, **tr_r)
        yard = " + ".join(k for k, on in (("local fills", loc), ("values fills", val)) if on)
        say(f"lbm_stream_collide[halo+slots] rank {r_s} level {lmax} {label} "
            f"({len(listed)} of {f_r.shape[0]} blocks; {tr_r['rows']} ghost rows, {tr_r['payload_rows']} of them from "
            f"{len(msg_t) if pay else 0} payloads, {len(local_t)} local segments; yardstick {yard} + stencil): "
            f"max |err| {bitwise:.1e} against the fills then the stencil, {err:.3e} against plain; medians of 30 "
            f"single calls in turn (quartiles): "
            + ", ".join(f"{k} {m:.4f} ms ({q1:.4f}-{q3:.4f})" for k, (m, q1, q3) in med.items())
            + f"; plain {plain_ms_:.4f} ms; bound {bound_ms_:.4f} ms ({by_}), {bound_ms_ / med['route'][0]:.1%} of bound "
            f"({bound_ms_ / med['block order'][0]:.1%} in block order); whole octets in its {octets[2]} launch "
            f"groups {octets[0]} in block order, {octets[1]} in neighbour order; payload rows a CTA's map tile "
            f"names {json.dumps(tiles)}")
    halves_ms = {k: rank_rows["interior half"][k] + rank_rows["boundary half"][k]
                 for k in ("ms", "block_order_ms", "fill_then_stencil_ms")}
    unsplit_row = rank_rows["unsplit level"]
    say(f"rank {r_s} level {lmax}: the two halves together take {halves_ms['ms']:.4f} ms on the route "
        f"({halves_ms['block_order_ms']:.4f} in block order, {halves_ms['ms'] / halves_ms['block_order_ms'] - 1:+.1%}) "
        f"and {halves_ms['fill_then_stencil_ms']:.4f} ms as fills then stencils (the same work on all sides); "
        f"unsplit {unsplit_row['ms']:.4f} ({unsplit_row['block_order_ms']:.4f} in block order, "
        f"{unsplit_row['ms'] / unsplit_row['block_order_ms'] - 1:+.1%}) against {unsplit_row['fill_then_stencil_ms']:.4f} ms")
    del out_route, out_fill, work_r, srcs_r, payloads_s, hm_r, out_s, fs_pdfs

    # the member routes at main-path shapes: the serving members' level-2
    # coefficients on M = 4 distinct states of the level-2 stack, stencil
    # and fill, each held bitwise against M solo launches of the same kernel
    M = len(members)
    phys = [(omega_for_level(m["omega"], lmax), m["u_lid"]) for m in members]
    mc = member_coeffs([o for o, _u in phys], [u for _o, u in phys], lattice=lattice, collision=cfg.collision,
                       dtype=f_fine.dtype, device="cuda")
    fm = torch.empty((M, *f_fine.shape), dtype=f_fine.dtype, device="cuda")
    for m in range(M):
        torch.mul(f_fine, 1.0 + 1e-3 * m, out=fm[m])
    out_m = torch.empty_like(fm)
    lbm_stream_collide(fm, m_fine, members=mc, out=out_m)
    km_solo_err = 0.0
    for m, (om, u) in enumerate(phys):
        solo_out = lbm_stream_collide(fm[m], m_fine, omega=om, u_wall=u, lattice=lattice, collision=cfg.collision)
        torch.cuda.synchronize()
        km_solo_err = max(km_solo_err, max_err(out_m[m], solo_out))
    del solo_out
    check(km_solo_err == 0.0, f"the member stencil equals M solo launches bitwise ({km_solo_err})")
    chunk = 64  # the plain version, 64 blocks at a time: its temporaries for the whole stack do not fit

    def plain_members(compare=False):
        worst = 0.0
        for b0 in range(0, B2, chunk):
            res = stream_collide_into(fm[:, b0:b0 + chunk], m_fine[b0:b0 + chunk], mc.host, lattice=lattice,
                                      collision=cfg.collision)
            if compare:
                torch.testing.assert_close(out_m[:, b0:b0 + chunk], res, **TOL[torch.float32])
                worst = max(worst, max_err(out_m[:, b0:b0 + chunk], res))
        return worst

    km_err = plain_members(compare=True)
    km_ms = time_ms(lambda: lbm_stream_collide(fm, m_fine, members=mc, out=out_m), iters=20)
    km_solos_ms = time_ms(lambda: [lbm_stream_collide(fm[m], m_fine, omega=om, u_wall=u, lattice=lattice,
                                                      collision=cfg.collision, out=out_m[m])
                                   for m, (om, u) in enumerate(phys)], iters=20)
    km_plain_ms = time_ms(plain_members, iters=2, warmup=1)
    fluid2 = int((m_fine == 0).sum())
    km_bytes = 2 * fm.numel() * fm.element_size() + m_fine.numel() * m_fine.element_size() + mc.table.numel() * 4
    km_bound_ms, km_by = max((km_bytes / HBM_BYTES_PER_S * 1e3, "bytes"),
                             (M * fluid2 * flops_per_fluid_cell(lattice.Q, cfg.collision) / FP32_FLOPS_PER_S * 1e3,
                              "operations"))
    say(f"lbm_stream_collide[members] M={M} x level {lmax} B={B2} 34^3 D3Q19 TRT f32: max |err| {km_solo_err:.1e} "
        f"against {M} solo launches, {km_err:.3e} against plain; kernel {km_ms:.4f} ms ({M} solo launches "
        f"{km_solos_ms:.4f} ms), plain {km_plain_ms:.4f} ms (in chunks of {chunk} blocks), bound {km_bound_ms:.4f} ms "
        f"({km_by}; {M} x the solo bound: {M * sten2_bound_ms:.4f} ms), {km_bound_ms / km_ms:.1%} of bound")
    del fm, out_m

    # the level-2 fill of the cavity for M members: member stacks of every level
    stacks = []
    for b in bufs:
        st = torch.empty((M, *b.shape), dtype=b.dtype, device="cuda")
        for m in range(M):
            torch.mul(b, 1.0 + 1e-3 * m, out=st[m])
        stacks.append(st)

    def member_fill(fill_fn, work):
        for t in tables[lmax]:
            fill_fn(work[i2], work[t.src], t.kind, t.dst_slot, t.dst_cell, t.src_slot, t.src_cell)

    got_w, want_w = list(stacks), list(stacks)
    got_w[i2], want_w[i2] = stacks[i2].clone(), stacks[i2].clone()
    member_fill(lbm_halo_fill, got_w)
    kf_solo_err = 0.0
    for m in range(M):
        solo_w = [st[m] for st in stacks]
        solo_w[i2] = stacks[i2][m].clone()
        member_fill(lbm_halo_fill, solo_w)
        torch.cuda.synchronize()
        kf_solo_err = max(kf_solo_err, max_err(got_w[i2][m], solo_w[i2]))
    del solo_w
    check(kf_solo_err == 0.0, f"the member fill equals M solo launches bitwise ({kf_solo_err})")
    member_fill(halo_fill_ref, want_w)
    torch.cuda.synchronize()
    kf_err = max_err(got_w[i2], want_w[i2])
    check(kf_err == 0.0, f"the member fill equals its plain version bitwise ({kf_err})")
    solo_ws = [[st[m] for st in got_w] for m in range(M)]
    kf_ms = time_ms(lambda: member_fill(lbm_halo_fill, got_w), iters=20)
    kf_solos_ms = time_ms(lambda: [member_fill(lbm_halo_fill, w) for w in solo_ws], iters=20)
    kf_plain_ms = time_ms(lambda: member_fill(halo_fill_ref, want_w), iters=2, warmup=1)
    kf_bytes = M * (tr["rows"] + tr["src_own"] + tr["src_other"]) * row_bytes + tr["index_bytes"]
    kf_bound_ms = kf_bytes / HBM_BYTES_PER_S * 1e3
    say(f"lbm_halo_fill[members] M={M} x level {lmax} ({rows2} ghost rows a member, {len(tables[lmax])} launches): "
        f"max |err| {kf_solo_err:.1e} against {M} solo launches, {kf_err:.1e} against plain; kernel {kf_ms:.4f} ms "
        f"({M} x {len(tables[lmax])} solo launches {kf_solos_ms:.4f} ms), plain {kf_plain_ms:.4f} ms, bound "
        f"{kf_bound_ms:.4f} ms (bytes, the tables once; {M} x the solo bound: {M * fill_bound_ms:.4f} ms), "
        f"{kf_bound_ms / kf_ms:.1%} of bound")
    del got_w, want_w, solo_ws

    # the member halo route: the level's halo step for M members in one
    # launch, bitwise M solo halo launches and the member fill then the
    # member stencil (the schedule it replaces)
    mstacks = tuple(stacks)
    del stacks
    sched_w = list(mstacks)
    sched_w[i2] = mstacks[i2].clone()
    sched_out = torch.empty_like(mstacks[i2])

    def member_fill_then_stencil():
        member_fill(lbm_halo_fill, sched_w)
        return lbm_stream_collide(sched_w[i2], m_fine, members=mc, out=sched_out)

    member_fill_then_stencil()
    kmh_sched_ms = time_ms(member_fill_then_stencil, iters=20)
    del sched_w
    out_mh = torch.empty_like(mstacks[i2])

    def member_halo():
        return lbm_stream_collide(mstacks[i2], m_fine, members=mc, halo=hmap2, sources=mstacks, out=out_mh)

    member_halo()
    torch.cuda.synchronize()
    kmh_bitwise = max_err(out_mh, sched_out)
    del sched_out
    check(kmh_bitwise == 0.0, f"the member halo route equals the member fill then stencil bitwise ({kmh_bitwise})")
    kmh_solo_err = 0.0
    for m, (om, u) in enumerate(phys):
        solo_out = lbm_stream_collide(mstacks[i2][m], m_fine, halo=hmap2, sources=tuple(st[m] for st in mstacks),
                                      omega=om, u_wall=u, lattice=lattice, collision=cfg.collision)
        torch.cuda.synchronize()
        kmh_solo_err = max(kmh_solo_err, max_err(out_mh[m], solo_out))
        del solo_out
    check(kmh_solo_err == 0.0, f"the member halo route equals M solo halo launches bitwise ({kmh_solo_err})")
    kmh_ms = time_ms(member_halo, iters=20)
    plain_w = list(mstacks)

    def plain_member_halo(compare=False):
        plain_w[i2] = mstacks[i2].clone()  # the plain version fills a clone
        member_fill(halo_fill_ref, plain_w)
        worst = 0.0
        for b0 in range(0, B2, chunk):
            res_ = stream_collide_into(plain_w[i2][:, b0:b0 + chunk], m_fine[b0:b0 + chunk], mc.host,
                                       lattice=lattice, collision=cfg.collision)
            if compare:
                torch.testing.assert_close(out_mh[:, b0:b0 + chunk], res_, **TOL[torch.float32])
                worst = max(worst, max_err(out_mh[:, b0:b0 + chunk], res_))
        return worst

    kmh_err = plain_member_halo(compare=True)
    kmh_plain_ms = time_ms(plain_member_halo, iters=1, warmup=0)
    kmh_bytes = km_bytes + M * (tr["src_other"] - tr["rows"]) * row_bytes + tr["index_bytes"]
    kmh_bound_ms, kmh_by = max((kmh_bytes / HBM_BYTES_PER_S * 1e3, "bytes"),
                               (M * fluid2 * flops_per_fluid_cell(lattice.Q, cfg.collision) / FP32_FLOPS_PER_S * 1e3,
                                "operations"))
    say(f"lbm_stream_collide[halo+members] M={M} x level {lmax} B={B2} D3Q19 TRT f32: max |err| {kmh_solo_err:.1e} "
        f"against {M} solo halo launches, {kmh_bitwise:.1e} against the member fill then the member stencil, "
        f"{kmh_err:.3e} against plain; kernel {kmh_ms:.4f} ms, member fill then stencil {kmh_sched_ms:.4f} ms, "
        f"plain {kmh_plain_ms:.4f} ms, bound {kmh_bound_ms:.4f} ms ({kmh_by}), {kmh_bound_ms / kmh_ms:.1%} of bound")
    del mstacks, out_mh, plain_w

    # small cases: stencil and slab form at D3Q27 / BGK / f64 / odd extents
    rng = np.random.default_rng(0)
    for lat, coll, dtype, shape in (
        (D3Q27, "bgk", torch.float32, (18, 18, 18)),
        (D3Q27, "trt", torch.float32, (10, 12, 14)),
        (D3Q19, "bgk", torch.float64, (16, 16, 16)),
        (D3Q19, "trt", torch.float64, (9, 11, 7)),
        (D3Q19, "trt", torch.float32, (33, 17, 35)),
        (D3Q27, "trt", torch.float64, (5, 3, 300)),
    ):
        B = 4
        w = torch.as_tensor(lat.w, dtype=dtype)[None, :, None, None, None]
        f = (w * (1 + 0.05 * torch.as_tensor(rng.standard_normal((B, lat.Q, *shape)), dtype=dtype))).cuda()
        mask = torch.zeros((B, *shape), dtype=torch.int32)
        mask[:, 0], mask[:, -1], mask[:, :, 0] = 1, 2, 1
        mask = mask.cuda()
        kw = dict(omega=1.3, lattice=lat, u_wall=(0.05, 0.01, 0.0), collision=coll)
        got, want = lbm_stream_collide(f, mask, **kw), stream_collide_ref(f, mask, **kw)
        torch.cuda.synchronize()
        err1 = max_err(got, want)
        torch.testing.assert_close(got, want, **TOL[dtype])
        # the slab form on a random ghost-ring fill of each block
        X, Y, Z = shape
        ring = np.flatnonzero(np.pad(np.zeros((X - 2, Y - 2, Z - 2), bool), 1, constant_values=True))
        slots_ = np.repeat(np.arange(B), 5 + np.arange(B))
        cells_ = np.concatenate([rng.choice(ring, 5 + b, replace=False) for b in range(B)])
        e, c, v = _pad_fill_layout(slots_, cells_, B, shape)
        rows = torch.as_tensor(rng.standard_normal((len(cells_), lat.Q)) * 0.01 + 0.05, dtype=dtype)
        args = (rows[torch.as_tensor(e, dtype=torch.long)], torch.as_tensor(c), torch.as_tensor(v))
        want = lbm_stream_collide_halo(f.cpu(), mask.cpu(), *args, **kw)
        got = lbm_stream_collide_halo(f.clone(), mask, *(a.cuda() for a in args), **kw)
        torch.cuda.synchronize()
        err2 = max_err(got.cpu(), want)
        torch.testing.assert_close(got.cpu(), want, **TOL[dtype])
        say(f"small case {lat.name} {coll} {str(dtype)[6:]} B={B} {shape}: "
            f"max |err| stencil {err1:.3e}, slab form {err2:.3e}")

    # small cases: the fill from sources, every segment kind, f32/f64 x D3Q19/D3Q27
    forest_s, reg_s, arena_s = refined_forest((6, 4, 8))
    levels_s = arena_s.levels()
    index_s = {l: i for i, l in enumerate(levels_s)}
    fills_s = lower_halo_fill(compile_ghost_plan(
        forest_s, reg_s, {l: arena_s.slots(l) for l in levels_s}, fields=("pdf",)))
    tables_s = {l: fill_tables(f, index_s, "cuda") for l, f in fills_s.items()}
    kinds = {t.kind for ts in tables_s.values() for t in ts}
    check(kinds == {"same", "coarse", "fine"}, f"the small forest's fills hold every kind: {kinds}")
    for lat in (D3Q19, D3Q27):
        for dtype in (torch.float32, torch.float64):
            sbufs = [
                torch.as_tensor(0.05 + 0.01 * rng.standard_normal(
                    (arena_s.num_blocks(l), lat.Q, *arena_s.buffer(l, "pdf").shape[2:])), dtype=dtype).cuda()
                for l in levels_s
            ]
            worst = 0.0
            for l, ts in tables_s.items():
                for t in ts:
                    got, want = list(sbufs), list(sbufs)
                    got[index_s[l]], want[index_s[l]] = sbufs[index_s[l]].clone(), sbufs[index_s[l]].clone()
                    args = (t.kind, t.dst_slot, t.dst_cell, t.src_slot, t.src_cell)
                    lbm_halo_fill(got[index_s[l]], got[t.src], *args)
                    halo_fill_ref(want[index_s[l]], want[t.src], *args)
                    torch.cuda.synchronize()
                    torch.testing.assert_close(got[index_s[l]], want[index_s[l]], **TOL[dtype])
                    worst = max(worst, max_err(got[index_s[l]], want[index_s[l]]))
            say(f"small case fill {lat.name} {str(dtype)[6:]} (same/coarse/fine segments of a "
                f"{len(levels_s)}-level forest): max |err| {worst:.3e}")

    say(f"phase 6 peak {torch.cuda.max_memory_allocated() / 1e9:.3f} GB allocated on the card "
        f"({(torch.cuda.max_memory_allocated() - mem6) / 1e9:.3f} GB above its start)")

    # -- 7. cross-check at a smaller depth ----------------------------------------
    if lm:
        cross_check_phase(forest_of)

    # -- 8. the LM and kernels lines and the result -------------------------------
    by_path = {"fused": fused_launches, "arena": arena_launches, "fused_sharded": fs_launches,
               "device_sharded": ds_launches, "serving": serving_launches, "analysis": analysis_launches}

    def path_launches(key):
        return {path: counts[key] for path, counts in by_path.items()}

    kernels = [
        dict(name="lbm_stream_collide", route="cuda", source=KERNEL_SOURCE, replaces=KERNEL1_REPLACES,
             launches=fused_launches["lbm_stream_collide"], launches_by_path=path_launches("lbm_stream_collide"),
             max_abs_err=k1_err, ms=k1_ms,
             plain_ms=k1_plain_ms, bound_ms=k1_bound_ms, bound_by=k1_by, library_ms=None,
             registers=main_stencil["registers"], spills=main_stencil["local_bytes"],
             occupancy=main_stencil["occupancy"], shape="B=64 34^3 D3Q19 TRT f32"),
        # the halo kernel's work on the main path: one launch of the
        # stencil's halo route a filled level, each ghost value read from
        # its source (fused; the ensemble's below)
        dict(name="lbm_stream_collide[halo]", route="cuda", source=KERNEL_SOURCE, replaces=KERNEL2_REPLACES,
             launches=fused_launches["lbm_stream_collide[halo]"],
             launches_by_path=path_launches("lbm_stream_collide[halo]"), max_abs_err=kh_err,
             max_abs_err_fill_then_stencil=kh_bitwise, ms=kh_ms, plain_ms=k2_plain_ms, bound_ms=k2_bound_ms,
             bound_by=k2_by, library_ms=None, registers=halo_stencils["trt+halo"]["registers"],
             spills=halo_stencils["trt+halo"]["local_bytes"], occupancy=halo_stencils["trt+halo"]["occupancy"],
             per_level_ms={str(l): r for l, r in per_level.items()},
             fill_then_stencil_ms=k2_ms, shape=f"level {lmax} B={B2}, {rows2} ghost rows, D3Q19 TRT f32"),
        dict(name="lbm_stream_collide[halo+members]", route="cuda", source=KERNEL_SOURCE,
             replaces=KERNEL2_REPLACES, launches=serving_launches["lbm_stream_collide[halo+members]"],
             launches_by_path=path_launches("lbm_stream_collide[halo+members]"), max_abs_err=kmh_err,
             max_abs_err_solo_launches=kmh_solo_err, max_abs_err_fill_then_stencil=kmh_bitwise, ms=kmh_ms,
             fill_then_stencil_ms=kmh_sched_ms, plain_ms=kmh_plain_ms, bound_ms=kmh_bound_ms, bound_by=kmh_by,
             library_ms=None, registers=halo_stencils["trt+halo+members"]["registers"],
             spills=halo_stencils["trt+halo+members"]["local_bytes"],
             occupancy=halo_stencils["trt+halo+members"]["occupancy"],
             shape=f"M={M} x level {lmax} B={B2} 34^3 D3Q19 TRT f32"),
        # the halo kernel on the rank paths: a rank's level, its local rows
        # and its inbound payloads' rows read through one map, over a slot
        # list in neighbour order (a half of fused_sharded's split, or the
        # whole level in device_sharded and the unsplit absorbs)
        dict(name="lbm_stream_collide[halo+slots]", route="cuda", source=KERNEL_SOURCE, replaces=KERNEL2_REPLACES,
             launches=fs_launches["lbm_stream_collide[halo+slots]"],
             launches_by_path=path_launches("lbm_stream_collide[halo+slots]"),
             max_abs_err=rank_rows["boundary half"]["max_abs_err"],
             max_abs_err_fill_then_stencil=rank_rows["boundary half"]["max_abs_err_fill_then_stencil"],
             ms=rank_rows["boundary half"]["ms"], fill_then_stencil_ms=rank_rows["boundary half"]["fill_then_stencil_ms"],
             plain_ms=rank_rows["boundary half"]["plain_ms"], bound_ms=rank_rows["boundary half"]["bound_ms"],
             bound_by=rank_rows["boundary half"]["bound_by"], library_ms=None,
             registers=halo_stencils["trt+slots+halo+payloads"]["registers"],
             spills=halo_stencils["trt+slots+halo+payloads"]["local_bytes"],
             occupancy=halo_stencils["trt+slots+halo+payloads"]["occupancy"], rank_level=rank_rows,
             shape=f"rank {r_s} level {lmax}: boundary half, {slots_np.size} of {f_r.shape[0]} blocks, "
                   f"D3Q19 TRT f32"),
        # the stencil over a slot list (interior and boundary halves of
        # levels without rows)
        dict(name="lbm_stream_collide[slots]", route="cuda", source=KERNEL_SOURCE, replaces=KERNEL1_REPLACES,
             launches=fs_launches["lbm_stream_collide[slots]"],
             launches_by_path=path_launches("lbm_stream_collide[slots]"), max_abs_err=ks_err,
             max_abs_err_whole_stack=ks_bitwise, ms=ks_ms, plain_ms=ks_plain_ms, bound_ms=ks_bound_ms,
             bound_by=ks_by, library_ms=None,
             shape=f"rank {r_s} level {lmax}: {slots_np.size} of {f_r.shape[0]} blocks, D3Q19 TRT f32"),
        # the member routes of both kernels on the serving path: one launch
        # for all members of an ensemble
        dict(name="lbm_stream_collide[members]", route="cuda", source=KERNEL_SOURCE, replaces=KERNEL1_REPLACES,
             launches=serving_launches["lbm_stream_collide[members]"],
             launches_by_path=path_launches("lbm_stream_collide[members]"), max_abs_err=km_err,
             max_abs_err_solo_launches=km_solo_err, ms=km_ms, solo_launches_ms=km_solos_ms, plain_ms=km_plain_ms,
             bound_ms=km_bound_ms, bound_by=km_by, library_ms=None,
             registers=member_stencil["registers"], spills=member_stencil["local_bytes"],
             occupancy=member_stencil["occupancy"], shape=f"M={M} x level {lmax} B={B2} 34^3 D3Q19 TRT f32"),
    ]
    say("card:", card_line())
    for line in lm_lines:
        print(json.dumps(line))
    print(json.dumps({"kernels": kernels}))
    ok_line()
    return 0


def cross_check_phase(forest_of) -> None:
    """Phase 7: every mode on the kernels and the plain versions at the
    cross-check's depth, and the tracers of restack against fused_sharded."""
    from repro_torch.lbm.criteria import macroscopic
    from repro_torch.lbm.driver import AMRLBM, LidDrivenCavityConfig
    from repro_torch.lbm.lattice import D3Q19
    from repro_torch.particles import ParticlesConfig, all_particles

    lattice = D3Q19
    runs = {}
    for mode, backend in (("restack", "cuda"), ("arena", "cuda"), ("fused", "cuda"), ("fused", "ref"),
                          ("sharded", "cuda"), ("fused_sharded", "cuda"), ("fused_sharded", "ref"),
                          ("device_sharded", "cuda"), ("device_sharded", "ref")):
        t0 = time.perf_counter()
        over = dict(rank_devices=SHARED_CARD) if mode == "device_sharded" else {}
        s = AMRLBM(LidDrivenCavityConfig(stepping_mode=mode, kernel_backend=backend, **CROSS_CHECK, **over))
        s.run(8, amr_interval=4)
        s.materialize_host()
        runs[mode, backend] = s
        say(f"cross-check {mode}/{backend}: {s.forest.num_blocks()} blocks, levels "
            f"{s.forest.levels_in_use()}, mass {s.total_mass():.6f}, {time.perf_counter() - t0:.2f} s")
    ref = runs["restack", "cuda"]
    check(ref.amr_cycles >= 1 and len(ref.forest.levels_in_use()) > 1, "cross-check spans an AMR event")
    forest_ref = {(b.bid, b.level, b.owner) for b in ref.forest.all_blocks()}
    ref_blocks = {b.bid: b for b in ref.forest.all_blocks()}
    worst = 0.0
    for key, s in runs.items():
        check({(b.bid, b.level, b.owner) for b in s.forest.all_blocks()} == forest_ref,
              f"{key} grew the same forest")
        for b in s.forest.all_blocks():
            rho, u = macroscopic(b.data["pdf"], lattice)
            rho_r, u_r = macroscopic(ref_blocks[b.bid].data["pdf"], lattice)
            a = torch.from_numpy(np.concatenate([s.spec.interior(rho)[None], s.spec.interior(u)]))
            r = torch.from_numpy(np.concatenate([s.spec.interior(rho_r)[None], s.spec.interior(u_r)]))
            torch.testing.assert_close(a, r, **TOL[torch.float32])
            worst = max(worst, max_err(a, r))
    say(f"cross-check: restack/arena/fused/sharded/fused_sharded/device_sharded on the kernels and "
        f"fused/fused_sharded/device_sharded on the plain versions agree: same forest, interior rho/u max |diff| "
        f"{worst:.3e} (rtol 3e-5, atol 3e-6)")

    def bitwise(a, b) -> bool:
        want = {blk.bid: b.spec.interior(blk.data["pdf"]) for blk in b.forest.all_blocks()}
        return all(np.array_equal(a.spec.interior(blk.data["pdf"]), want[blk.bid]) for blk in a.forest.all_blocks())

    for backend in ("cuda", "ref"):
        check(bitwise(runs["device_sharded", backend], runs["fused", backend]),
              f"cross-check device_sharded/{backend} interiors bitwise fused/{backend}'s")
    say("cross-check: device_sharded equals fused bitwise on the kernels and on the plain versions")
    ncards = torch.cuda.device_count()
    if ncards >= 2:
        spread = tuple(f"cuda:{r % ncards}" for r in range(CROSS_CHECK["nranks"]))
        t0 = time.perf_counter()
        s = AMRLBM(LidDrivenCavityConfig(stepping_mode="device_sharded", kernel_backend="cuda", rank_devices=spread,
                                         **CROSS_CHECK))
        s.run(8, amr_interval=4)
        s.materialize_host()
        check(forest_of(s) == forest_of(runs["fused", "cuda"]) and bitwise(s, runs["fused", "cuda"]),
              f"device_sharded with ranks on {spread} equals fused bitwise")
        say(f"cross-check device_sharded/cuda with ranks on {','.join(spread)} (peer copies): bitwise fused/cuda, "
            f"{time.perf_counter() - t0:.2f} s")
        del s
    else:
        say(f"cross-check device_sharded with ranks on distinct cards: not run, {ncards} card visible")
    del runs, ref, ref_blocks

    tracer_runs = {}
    for mode in ("restack", "fused_sharded"):
        t0 = time.perf_counter()
        s = AMRLBM(LidDrivenCavityConfig(stepping_mode=mode, kernel_backend="cuda",
                                         particles=ParticlesConfig(**TRACERS_CROSS), **CROSS_CHECK))
        n0 = s.total_particles()
        s.run(8, amr_interval=4)
        check(s.amr_cycles >= 1 and s.total_particles() == n0 > 0, f"{mode} with tracers conserves {n0}")
        tracer_runs[mode] = s
        say(f"cross-check {mode}/cuda with {n0} tracers: moved {s.particles_moved}, "
            f"{time.perf_counter() - t0:.2f} s")
    a, b = (tracer_runs[m] for m in ("restack", "fused_sharded"))
    check(forest_of(a) == forest_of(b), "restack and fused_sharded with tracers grew the same forest")
    pa, pb = all_particles(a.forest), all_particles(b.forest)
    check(np.array_equal(pa["id"], pb["id"]), "the same tracer ids")
    tr_err = float(np.abs(pa["pos"] - pb["pos"]).max())
    check(tr_err <= 1e-10, f"tracer positions by id within 1e-10 ({tr_err:.3e})")
    say(f"cross-check tracers: restack and fused_sharded agree on {pa['id'].size} tracers, "
        f"max |position diff| {tr_err:.3e} (limit 1e-10)")



def ok_line() -> None:
    say(f"chip_smoke wall time {time.perf_counter() - T_START:.2f} s")
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": torch.cuda.get_device_name(0), "count": torch.cuda.device_count(),
    }}))


def only(phases: list[str]) -> int:
    """``--only lm,lm-families,lm-train,lm-dist``: just the named LM phases, in the order
    given, each with its JSON line, then the ok line (no kernel runs, so no
    ``kernels`` line)."""
    if not torch.cuda.is_available():
        print("chip_smoke: no CUDA device is available", file=sys.stderr)
        return 2
    runs = {"lm": ("lm_serve", lm_serving_phase), "lm-families": ("lm_families", lm_families_phase),
            "lm-train": ("lm_train", lm_train_phase), "lm-dist": ("lm_dist", lm_dist_phase)}
    check(phases and set(phases) <= set(runs), f"--only takes a comma list of {sorted(runs)}")
    lines = [{runs[p][0]: runs[p][1]()} for p in phases]
    say("card:", card_line())
    for line in lines:
        print(json.dumps(line))
    ok_line()
    return 0


T_START = time.perf_counter()

if __name__ == "__main__":
    if len(sys.argv) == 3 and sys.argv[1] == "--only":
        sys.exit(main(lm=False) if sys.argv[2] == "cavity" else only(sys.argv[2].split(",")))
    check(len(sys.argv) == 1, "usage: python3 chip_smoke.py [--only cavity | --only lm,lm-families,lm-train,lm-dist]")
    sys.exit(main())
