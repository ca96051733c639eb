"""Decode at ``long_500k``'s positions: the port against the JAX package, on
the CPU, at reduced width.

Three reduced archs at 2 layers take decode steps from position 524,286 to
524,289, across ``long_500k``'s length (``SHAPES["long_500k"]``, 524,288):
mixtral-8x7b into its 64-slot sliding-window ring (wrapped 8,191 times
before the first step), zamba2-2.7b with one shared-attention site over a
cache of all 524,288 slots (the ring wraps to slot 0 at the third step), and
qwen2-vl-72b with M-RoPE's three position streams at those positions over 16
slots. The JAX weights come from ``repro.models.zoo``'s ``init`` and reach
the port through ``from_reference_params``; both caches hold the same seeded
values (``np.random.default_rng``). Each step's logits, then every cache
tensor, agree within ``tests/test_torch_lm_families.py``'s f32 tolerance
(rtol 1e-5, atol 1e-5).
"""

from dataclasses import replace

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.configs import get_config as jax_get_config
from repro.models import zoo as jzoo
from repro_torch.configs import SHAPES, get_config
from repro_torch.models.convert import from_reference_params

torch.set_num_threads(1)

F32 = dict(rtol=1e-5, atol=1e-5)
LONG = SHAPES["long_500k"].seq_len
# arch: the cache length asked of init_cache (mixtral's is clamped to its window)
CACHE = {"mixtral-8x7b": LONG, "zamba2-2.7b": LONG, "qwen2-vl-72b": 16}
FIRST, STEPS = LONG - 2, 4


@pytest.fixture(autouse=True)
def _no_autograd():
    with torch.no_grad():
        yield


def _leaves(cache: dict, prefix: str = ""):
    for name, value in sorted(cache.items()):
        if isinstance(value, dict):
            yield from _leaves(value, f"{prefix}{name}.")
        else:
            yield f"{prefix}{name}", value


def _jax_tree(cache: dict) -> dict:
    """The port's cache as the JAX package's: the same keys, the same values."""
    return {k: _jax_tree(v) if isinstance(v, dict) else jnp.asarray(v.numpy()) for k, v in cache.items()}


@pytest.mark.parametrize("arch", list(CACHE))
def test_decode_across_long_500k_matches_reference(arch):
    cfg = replace(get_config(arch).reduced(), n_layers=2)
    jcfg = replace(jax_get_config(arch).reduced(), n_layers=2)
    jm = jzoo.build_model(jcfg, jzoo.DistContext(remat=False))
    params = jm.init(jax.random.PRNGKey(0), jnp.float32)
    tm = from_reference_params(cfg, jax.tree.map(np.asarray, params), device="cpu")
    rng = np.random.default_rng(0)

    tc = tm.init_cache(1, CACHE[arch])
    slots = tc["k"].shape[2]
    assert slots == (cfg.sliding_window or CACHE[arch])
    for _, leaf in _leaves(tc):
        if leaf.is_floating_point():
            leaf.copy_(torch.from_numpy(0.5 * rng.standard_normal(tuple(leaf.shape), dtype=np.float32)))
    tc["pos"] = torch.tensor(FIRST, dtype=torch.int32)
    jc = _jax_tree(tc)
    k0 = tc["k"].numpy().copy()
    decode = jax.jit(lambda p, t, c: jm.decode(p, t, c))

    tokens = rng.integers(0, cfg.vocab, (STEPS, 1, 1)).astype(np.int32)
    for step, tok in enumerate(tokens):
        jl, jc = decode(params, jnp.asarray(tok), jc)
        tl, tc = tm.decode(torch.from_numpy(tok), tc)
        np.testing.assert_allclose(tl.numpy(), np.asarray(jl), **F32, err_msg=f"{arch} at {FIRST + step}")
    assert int(tc["pos"]) == int(jc["pos"]) == FIRST + STEPS
    # each step wrote the slot of its position modulo the ring, and no other
    written = np.flatnonzero((tc["k"].numpy() != k0).any(axis=(0, 1, 3, 4)))
    assert written.tolist() == sorted((FIRST + i) % slots for i in range(STEPS))

    got, want = dict(_leaves(tc)), dict(_leaves(jc))
    assert sorted(got) == sorted(want)
    for name, t in got.items():
        if name != "pos":
            np.testing.assert_allclose(t.numpy(), np.asarray(want[name]), **F32, err_msg=f"{arch} cache {name}")
