"""The port's LM layer primitives and attention (``repro_torch.models.layers``,
``repro_torch.models.attention``) against the JAX package's, on the CPU.

Inputs are drawn with ``np.random.default_rng`` and go through both. f32
results agree within rtol 1e-5 / atol 1e-6 (the frameworks' transcendental
and reduction orders differ by an ulp or two); the bf16 norms and
``apply_rope`` agree **bitwise**, which pins the reference's cast order
(compute in f32, cast to ``x.dtype``, then scale in ``x.dtype``; cos/sin cast
to ``x.dtype``). The traps each of these tests catches:

* ``layer_norm``'s variance is the population one (``jnp.var``), not
  ``torch.var``'s unbiased default: at width 64 the two differ by 1.6 %.
* ``gelu`` is the tanh approximation (``jax.nn.gelu``'s default), not
  ``F.gelu``'s erf: they differ by up to about 1e-3.
* Rotary angles are f32 products of f32 positions and f32-rounded inverse
  frequencies: float64 angles at position 32k with theta = 1e6 move
  cos/sin by about 4e-4, far above the 1e-6 held here; past 524,288
  (``long_500k``) the two packages' f32 cos/sin still agree to 6e-8.
* Decode ages are a floor modulo, and the window / fill masks and the
  legacy roll layout (``slot=None``) are the reference's.
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.models import attention as jattn
from repro.models import layers as jlayers
from repro_torch.models import attention as tattn
from repro_torch.models import layers as tlayers

torch.set_num_threads(1)

F32 = dict(rtol=1e-5, atol=1e-6)


def _j(a, dtype=None):
    return jnp.asarray(a, dtype)


def _t(a, dtype=None):
    t = torch.from_numpy(np.array(a))
    return t.to(dtype) if dtype is not None else t


def _np(x) -> np.ndarray:
    if isinstance(x, torch.Tensor):
        return x.float().numpy()
    return np.asarray(jnp.asarray(x, jnp.float32))


@pytest.mark.parametrize("kind", ["rmsnorm", "layernorm", "layernorm-nonparametric"])
def test_norms_match_reference(kind):
    rng = np.random.default_rng(0)
    x = (3.0 * rng.standard_normal((4, 8, 64)) + 0.5).astype(np.float32)
    scale = (1.0 + 0.3 * rng.standard_normal(64)).astype(np.float32)
    bias = (0.3 * rng.standard_normal(64)).astype(np.float32)
    if kind == "rmsnorm":
        jp, tp, kind_ = {"scale": _j(scale)}, {"scale": _t(scale)}, "rmsnorm"
    elif kind == "layernorm":
        jp, tp, kind_ = {"scale": _j(scale), "bias": _j(bias)}, {"scale": _t(scale), "bias": _t(bias)}, "layernorm"
    else:
        jp, tp, kind_ = None, None, "layernorm"
    want = jlayers.norm(_j(x), jp, kind_)
    got = tlayers.norm(_t(x), tp, kind_)
    np.testing.assert_allclose(_np(got), _np(want), **F32)
    # bf16 input, f32 params: the reference's casts, bit for bit
    want = jlayers.norm(_j(x, jnp.bfloat16), jp, kind_)
    got = tlayers.norm(_t(x, torch.bfloat16), tp, kind_)
    assert got.dtype == torch.bfloat16
    np.testing.assert_array_equal(_np(got), _np(want))


@pytest.mark.parametrize("end", [32768, 524289], ids=["32k", "long_500k"])
def test_rope_and_mrope_match_reference_up_to_32k(end):
    """Positions below ``end``: 32,768, and past ``long_500k``'s 524,288 (the
    largest position a long decode starts from), the corners included; rope
    at head_dim 64 and 128, M-RoPE at (8, 12, 12) over 64 and at qwen2-vl's
    (16, 24, 24) over its head_dim 128, all at theta 1e6."""
    rng = np.random.default_rng(1)
    pos = rng.integers(0, end, (2, 16))
    pos[0, :4] = [0, 1, end - 2, end - 1]
    for hd in (64, 128):
        want_c, want_s = jlayers.rope_freqs(_j(pos), hd, 1e6)
        got_c, got_s = tlayers.rope_freqs(_t(pos), hd, 1e6)
        assert got_c.dtype == torch.float32 and got_c.shape == (2, 16, hd // 2)
        np.testing.assert_allclose(_np(got_c), _np(want_c), rtol=0, atol=1e-6)
        np.testing.assert_allclose(_np(got_s), _np(want_s), rtol=0, atol=1e-6)
        # the trap: float64 angles are visibly off at these positions
        inv = 1.0 / (1e6 ** (np.arange(0, hd, 2) / hd))
        assert np.abs(np.cos(pos[..., None] * inv) - _np(want_c)).max() > 1e-4

    pos3 = np.stack([pos, pos // 2, pos // 3], axis=1)  # (B, 3, S)
    for hd, sections in ((64, (8, 12, 12)), (128, (16, 24, 24))):
        want_c, want_s = jlayers.mrope_freqs(_j(pos3), hd, 1e6, sections)
        got_c, got_s = tlayers.mrope_freqs(_t(pos3), hd, 1e6, sections)
        np.testing.assert_allclose(_np(got_c), _np(want_c), rtol=0, atol=1e-6)
        np.testing.assert_allclose(_np(got_s), _np(want_s), rtol=0, atol=1e-6)

    x = rng.standard_normal((2, 16, 4, 64)).astype(np.float32)
    cos, sin = tlayers.rope_freqs(_t(pos), 64, 1e6)
    jc, js = jlayers.rope_freqs(_j(pos), 64, 1e6)
    np.testing.assert_allclose(_np(tlayers.apply_rope(_t(x), cos, sin)), _np(jlayers.apply_rope(_j(x), jc, js)), **F32)
    got = tlayers.apply_rope(_t(x, torch.bfloat16), cos, sin)
    want = jlayers.apply_rope(_j(x, jnp.bfloat16), jc, js)
    assert got.dtype == torch.bfloat16
    np.testing.assert_array_equal(_np(got), _np(want))


@pytest.mark.parametrize("activation", ["swiglu", "gelu", "relu2"])
def test_mlp_matches_reference(activation):
    rng = np.random.default_rng(2)
    x = rng.standard_normal((2, 5, 64)).astype(np.float32)
    p = {"w_up": rng.standard_normal((64, 128)) / 8, "w_down": rng.standard_normal((128, 64)) / 11}
    if activation == "swiglu":
        p["w_gate"] = rng.standard_normal((64, 128)) / 8
    p = {k: v.astype(np.float32) for k, v in p.items()}
    want = jlayers.mlp(_j(x), {k: _j(v) for k, v in p.items()}, activation)
    got = tlayers.mlp(_t(x), {k: _t(v) for k, v in p.items()}, activation)
    np.testing.assert_allclose(_np(got), _np(want), rtol=1e-5, atol=1e-5)


def test_init_linear_draws_normal_over_sqrt_fan_in():
    g = torch.Generator().manual_seed(0)
    w = tlayers.init_linear(g, (256, 512), torch.bfloat16)
    assert w.dtype == torch.bfloat16 and w.shape == (256, 512)
    assert abs(float(w.float().std()) * 256**0.5 - 1.0) < 0.02
    assert abs(float(w.float().mean())) < 1e-3


def _qkv(rng, B, S, T, H, Hkv, d=8):
    q = rng.standard_normal((B, S, H, d)).astype(np.float32)
    k = rng.standard_normal((B, T, Hkv, d)).astype(np.float32)
    v = rng.standard_normal((B, T, Hkv, d)).astype(np.float32)
    return q, k, v


@pytest.mark.parametrize(
    "causal, window, groups",
    [(True, None, 1), (False, None, 1), (True, 3, 1), (True, None, 2), (True, None, 4), (False, 5, 2)],
    ids=["causal", "noncausal", "window3", "gqa2", "gqa4", "noncausal-window5-gqa2"],
)
def test_chunked_attention_matches_reference(causal, window, groups):
    """S = 10 with chunks of 4: three q and kv chunks, the last padded."""
    rng = np.random.default_rng(3)
    q, k, v = _qkv(rng, 2, 10, 10, 4, 4 // groups)
    kw = dict(causal=causal, window=window, q_chunk=4, kv_chunk=4)
    want = jattn.chunked_attention(_j(q), _j(k), _j(v), **kw)
    got = tattn.chunked_attention(_t(q), _t(k), _t(v), **kw)
    assert got.shape == (2, 10, 4, 8) and got.dtype == torch.float32
    np.testing.assert_allclose(_np(got), _np(want), **F32)
    # bf16 inputs: f32 accumulation, one rounding at the end, as the reference
    got = tattn.chunked_attention(_t(q, torch.bfloat16), _t(k, torch.bfloat16), _t(v, torch.bfloat16), **kw)
    want = jattn.chunked_attention(_j(q, jnp.bfloat16), _j(k, jnp.bfloat16), _j(v, jnp.bfloat16), **kw)
    assert got.dtype == torch.bfloat16
    np.testing.assert_allclose(_np(got), _np(want), rtol=2**-7, atol=2**-7)


@pytest.mark.parametrize(
    "slot, fill, window",
    [(5, None, None), (5, 3, None), (2, None, 4), (None, None, None), (None, 4, 3), (0, 1, None)],
    ids=["slot", "slot-fill", "slot-window", "roll", "roll-fill-window", "first-step"],
)
@pytest.mark.parametrize("cache_dtype", ["f32", "bf16"])
def test_decode_attention_matches_reference(slot, fill, window, cache_dtype):
    """GQA with 2 groups against a ring of T = 7 slots; ``slot`` as a 0-d
    int32 tensor (the decode step's), ``None`` for the roll layout."""
    rng = np.random.default_rng(4)
    q, k, v = _qkv(rng, 2, 1, 7, 4, 2)
    jd, td = (jnp.float32, torch.float32) if cache_dtype == "f32" else (jnp.bfloat16, torch.bfloat16)
    kw_j = dict(window=window, fill=None if fill is None else jnp.int32(fill),
                slot=None if slot is None else jnp.int32(slot))
    kw_t = dict(window=window, fill=None if fill is None else torch.tensor(fill, dtype=torch.int32),
                slot=None if slot is None else torch.tensor(slot, dtype=torch.int32))
    want = jattn.decode_attention(_j(q, jd), _j(k, jd), _j(v, jd), **kw_j)
    got = tattn.decode_attention(_t(q, td), _t(k, td), _t(v, td), **kw_t)
    assert got.shape == (2, 1, 4, 8) and got.dtype == td
    tol = F32 if cache_dtype == "f32" else dict(rtol=2**-7, atol=2**-7)
    np.testing.assert_allclose(_np(got), _np(want), **tol)


def test_decode_ages_are_a_floor_modulo():
    """slot 1 of T = 5: slots 2..4 are ages 4..2 (negative differences wrap
    upward). With fill = 2 only ages 0 and 1 (slots 1 and 0) are attended:
    an fmod age would keep slots 2..4 (negative ages) instead."""
    T, d = 5, 4
    q = torch.ones((1, 1, 1, d))
    k = torch.zeros((1, T, 1, d))
    v = torch.arange(T, dtype=torch.float32).reshape(1, T, 1, 1).expand(1, T, 1, d).contiguous()
    out = tattn.decode_attention(q, k, v, fill=torch.tensor(2, dtype=torch.int32), slot=torch.tensor(1, dtype=torch.int32))
    torch.testing.assert_close(out, torch.full((1, 1, 1, d), 0.5))
