"""The port's moe, ssm, hybrid and audio serving paths against the JAX
package's, on the CPU, at the reduced configs.

The JAX weights come from ``repro.models.zoo.init_params(cfg, PRNGKey(seed))``
and are carried across by ``from_reference_params``; tokens and whisper's
frame embeddings come from ``np.random.default_rng``. Whisper's decode reads
its cross keys and values from the cache: the port writes them with
``Model.fill_cross_cache``, the JAX side from ``_encoder_forward`` and each
layer's cross ``wk``/``wv``, the products its prefill forms. Tolerances:

* f32: logits, loss and decode logits within ``tests/test_torch_lm_serve.py``'s
  ``F32`` (rtol 1e-5, atol 1e-5); greedy ``serve_step`` tokens identical.
* bf16: within that file's ``2**-5 * max|logits|``.
* Parameters round-trip bitwise through ``to_reference_params``.
* Module cases across a chunk boundary (rwkv6 time mix, S = 150 over chunks
  of 64; mamba2, S = 150 over chunks of 128): rtol 1e-5 and atol
  ``1e-5 * max|y|``. The mamba2 SSD sums over a chunk of 128 cost f32 about
  2e-6 of max|y|: each package's result lies that far from the port's
  float64 result (1.8e-6 and 1.5e-6), and the two packages 2.4e-6 apart.
  ``_F64_SCALE`` pins the port's f32 result to its float64 one.
* float64 against float64 (another chunk length, or decode against
  prefill): ``F64_REL * max|y|``, 1e-10, where one step rounded in f32
  would cost about 1e-7. These pin the float64 model that serves as the
  f32 model's witness on the card.
"""

from dataclasses import replace

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.configs import get_config as jax_get_config
from repro.models import mamba2 as jmamba2
from repro.models import moe as jmoe
from repro.models import rwkv6 as jrwkv6
from repro.models import zoo as jzoo
from repro.train.train_step import make_serve_step as jax_make_serve_step
from repro_torch.configs import get_config
from repro_torch.models import build_model, mamba2, moe, rwkv6
from repro_torch.models.convert import from_reference_params, to_reference_params
from repro_torch.models import zoo as tzoo
from repro_torch.train import make_serve_step

torch.set_num_threads(1)

ARCHS = ["granite-moe-1b-a400m", "mixtral-8x7b", "rwkv6-3b", "zamba2-2.7b", "whisper-small"]
F32 = dict(rtol=1e-5, atol=1e-5)
B, S, CACHE = 2, 12, 8
# a float64 result against another float64 result of the same sums in
# another order (about 1e-15 relative; f32 would be about 1e-7)
F64_REL = 1e-10
# a module's f32 result against the port's float64 one on the same inputs:
# at most this times max|y| (measured 1.8e-6 for mamba2 and 5.3e-7 for the
# rwkv6 time mix in the module cases)
_F64_SCALE = 5e-6


@pytest.fixture(autouse=True)
def _no_autograd():
    """Serving builds no autograd graph (``serve_step`` and ``Model.decode``
    run under ``torch.no_grad``); neither does a prefill here, though the
    parameters take gradients."""
    with torch.no_grad():
        yield


def _bf16_tol(want: np.ndarray) -> dict:
    return dict(rtol=0, atol=2**-5 * float(np.abs(want).max()))


def _module_tol(want: np.ndarray) -> dict:
    return dict(rtol=1e-5, atol=1e-5 * float(np.abs(want).max()))


def _t(a, dtype=None) -> torch.Tensor:
    t = torch.from_numpy(np.array(a))
    return t if dtype is None else t.to(dtype)


class Pair:
    """One reduced arch in both packages, with the same weights."""

    def __init__(self, arch: str, seed: int = 0, dtype: str = "f32", no_drops: bool = False):
        self.cfg = get_config(arch).reduced()
        self.jcfg = jax_get_config(arch).reduced()
        if no_drops:  # every expert can take every token
            self.cfg = replace(self.cfg, capacity_factor=self.cfg.n_experts / self.cfg.top_k)
            self.jcfg = replace(self.jcfg, capacity_factor=self.jcfg.n_experts / self.jcfg.top_k)
        self.jdt, self.tdt = (jnp.float32, torch.float32) if dtype == "f32" else (jnp.bfloat16, torch.bfloat16)
        self.jm = jzoo.build_model(self.jcfg, jzoo.DistContext(remat=False))
        self.params = self.jm.init(jax.random.PRNGKey(seed), self.jdt)
        self.tm = from_reference_params(self.cfg, jax.tree.map(np.asarray, self.params), device="cpu")
        self.rng = np.random.default_rng(seed)
        self._decode = jax.jit(lambda p, t, c: self.jm.decode(p, t, c))
        self.enc = None
        if self.cfg.is_encoder_decoder:
            self.enc = (0.5 * self.rng.standard_normal((B, self.cfg.encoder_len, self.cfg.d_model))).astype(np.float32)

    def batch(self, n: int, seq: int, labels: bool = False):
        toks = self.rng.integers(0, self.cfg.vocab, (n, seq)).astype(np.int32)
        jb, tb = {"tokens": jnp.asarray(toks)}, {"tokens": torch.from_numpy(toks)}
        if labels:
            lab = self.rng.integers(0, self.cfg.vocab, (n, seq)).astype(np.int32)
            lab[:, -3:] = -1
            lab[0, 1] = -1
            jb["labels"], tb["labels"] = jnp.asarray(lab), torch.from_numpy(lab)
        if self.enc is not None:
            jb["enc_embeds"], tb["enc_embeds"] = jnp.asarray(self.enc[:n]), torch.from_numpy(self.enc[:n])
        return toks, jb, tb

    def caches(self, n: int, cache_len: int, pos0: int | None):
        jc = self.jm.init_cache(n, cache_len, self.jdt)
        tc = self.tm.init_cache(n, cache_len, self.tdt)
        if pos0 is not None and "pos" in jc:
            jc["pos"] = jnp.zeros((), jnp.int32) + pos0
            tc["pos"] = torch.tensor(pos0, dtype=torch.int32)
        if self.enc is not None:
            self.tm.fill_cross_cache(tc, torch.from_numpy(self.enc[:n]))
            enc = jzoo._encoder_forward(self.jcfg, self.params, jnp.asarray(self.enc[:n]).astype(self.jdt),
                                        self.jm.dist)
            cross = self.params["cross"]["attn"]
            for name, w in (("ek", cross["wk"]), ("ev", cross["wv"])):
                jc[name] = jnp.stack([(enc @ w[i]).reshape(n, -1, self.cfg.n_kv, self.cfg.hd)
                                      for i in range(self.cfg.n_layers)]).astype(jc[name].dtype)
        return jc, tc

    def decode_both(self, token: np.ndarray, jc, tc):
        jl, jc = self._decode(self.params, jnp.asarray(token), jc)
        tl, tc = self.tm.decode(torch.from_numpy(token), tc)
        return np.asarray(jl.astype(jnp.float32)), tl.float().numpy(), jc, tc


def _cache_leaves(c: dict, prefix: str = ""):
    for k, v in sorted(c.items()):
        if isinstance(v, dict):
            yield from _cache_leaves(v, f"{prefix}{k}.")
        else:
            yield f"{prefix}{k}", v


def _assert_caches_close(tc: dict, jc: dict, tol=None):
    """Every cache tensor within ``tol`` (a dict, or a function of the JAX
    package's tensor giving one)."""
    got, want = dict(_cache_leaves(tc)), dict(_cache_leaves(jc))
    assert sorted(got) == sorted(want)
    for name, t in got.items():
        w = np.asarray(want[name]).astype(np.float32)
        assert tuple(t.shape) == w.shape, name
        if name == "pos":
            assert int(t) == int(w)
        else:
            np.testing.assert_allclose(t.float().numpy(), w, **(tol(w) if callable(tol) else tol), err_msg=name)


@pytest.mark.parametrize("arch", ARCHS)
def test_model_matches_reference(arch):
    """Logits, loss, and 6 decode steps from the default cache and, where
    the cache has a position, from ``pos = 0``, each against the JAX
    package; then every cache tensor."""
    pair = Pair(arch)
    toks, jb, tb = pair.batch(B, S, labels=True)
    want = np.asarray(jax.jit(pair.jm.logits)(pair.params, jb))
    got = pair.tm.logits(tb)
    assert got.shape == (B, S, pair.cfg.vocab) and got.dtype == torch.float32
    np.testing.assert_allclose(got.numpy(), want, **F32)

    jloss, jmetrics = jax.jit(pair.jm.loss)(pair.params, jb)
    tloss, tmetrics = pair.tm.loss(tb)
    np.testing.assert_allclose(float(tloss), float(jloss), **F32)
    np.testing.assert_allclose(float(tmetrics["aux"]), float(jmetrics["aux"]), **F32)
    assert float(tmetrics["tokens"]) == float(jmetrics["tokens"])

    for pos0 in (None, 0) if pair.cfg.family != "ssm" else (None,):
        jc, tc = pair.caches(B, CACHE, pos0)
        for t in range(6):
            jl, tl, jc, tc = pair.decode_both(toks[:, t : t + 1], jc, tc)
            assert tl.shape == (B, 1, pair.cfg.vocab)
            np.testing.assert_allclose(tl, jl, **F32, err_msg=f"pos0={pos0} step {t}")
        _assert_caches_close(tc, jc, F32)


@pytest.mark.parametrize("arch", ARCHS)
def test_serve_step_tokens_equal_reference(arch):
    """Greedy tokens identical to the JAX package's over 8 steps, each step
    fed the previous step's token, from a cache shorter than the run."""
    pair = Pair(arch, seed=1)
    jstep = jax.jit(jax_make_serve_step(pair.jm))
    tstep = make_serve_step(pair.tm)
    tok = pair.rng.integers(0, pair.cfg.vocab, (B, 1)).astype(np.int32)
    jt, tt = jnp.asarray(tok), torch.from_numpy(tok)
    jc, tc = pair.caches(B, 6, None)
    jseq, tseq = [], []
    for _ in range(8):
        jt, jc = jstep(pair.params, jt, jc, None)
        tt, tc = tstep(tt, tc)
        assert tt.dtype == torch.int32 and tt.shape == (B, 1)
        jseq.append(np.asarray(jt))
        tseq.append(tt.numpy())
    np.testing.assert_array_equal(np.concatenate(tseq, 1), np.concatenate(jseq, 1))


# bf16 MoE routes may flip between the packages where two router
# probabilities nearly tie: at most this many tokens may flip in a leg
MAX_ROUTE_FLIPS = 2


def _record_jax_routes(monkeypatch) -> list:
    """Make the JAX package's ``moe_layer`` record, through a debug callback
    (it runs under jit), the expert ids of each call, (B, S, K)."""
    calls: list = []
    orig = jzoo.moe_layer

    def recording(x, p, **kw):
        probs = jax.nn.softmax(jnp.einsum("bsd,de->bse", x, p["router"]).astype(jnp.float32), axis=-1)
        _, idx = jax.lax.top_k(probs, kw["top_k"])
        jax.debug.callback(lambda i: calls.append(np.asarray(i)), idx)
        return orig(x, p, **kw)

    monkeypatch.setattr(jzoo, "moe_layer", recording)
    return calls


def _first_flips(pair: "Pair", jax_calls: list, n_rows: int) -> np.ndarray:
    """Per request, the first position whose expert set differs between the
    packages in any layer (``n_rows`` where none does). A token's routes
    reach the later positions of its request through attention, so a
    comparison leaves out everything from that position on."""
    layers = pair.tm.layers
    got = [torch.cat(layer.routes, dim=1).numpy() for layer in layers]
    want = [np.concatenate(jax_calls[i :: len(layers)], axis=1) for i in range(len(layers))]
    jax_calls.clear()
    for layer in layers:
        layer.routes = []
    first = np.full(n_rows, 10**9)
    for g, w in zip(got, want):
        for b, t in np.argwhere((np.sort(g, -1) != np.sort(w, -1)).any(-1)):
            first[b] = min(first[b], t)
    return first


@pytest.mark.parametrize("arch", ARCHS)
def test_bf16_model_matches_reference(arch, monkeypatch):
    """bf16 weights and cache (norms, the router, the rwkv / mamba vectors
    and the recurrent states stay f32 on both sides). For moe, both packages
    run at a capacity factor that drops nothing (``n_experts / top_k``), the
    routes of every layer are compared, and a request is compared only up
    to its first token whose expert set differs (a near-tie of the router's
    probabilities, rounded differently by the two packages' bf16 products);
    at most ``MAX_ROUTE_FLIPS`` tokens may flip."""
    moe_arch = get_config(arch).family == "moe"
    pair = Pair(arch, seed=3, dtype="bf16", no_drops=moe_arch)
    assert pair.tm.embed.dtype == torch.bfloat16
    jax_calls = _record_jax_routes(monkeypatch) if moe_arch else None
    for layer in pair.tm.layers if moe_arch else ():
        layer.routes = []
    toks, jb, tb = pair.batch(B, S)
    want = np.asarray(jax.jit(pair.jm.logits)(pair.params, jb).astype(jnp.float32))
    got = pair.tm.logits(tb)
    assert got.dtype == torch.bfloat16
    first = _first_flips(pair, jax_calls, B) if moe_arch else np.full(B, S)
    flips = [first.copy()]
    for b in range(B):
        np.testing.assert_allclose(got.float().numpy()[b, : first[b]], want[b, : first[b]], **_bf16_tol(want))
    jc, tc = pair.caches(B, CACHE, 0)
    for t in range(6):
        jl, tl, jc, tc = pair.decode_both(toks[:, t : t + 1], jc, tc)
        if moe_arch:
            flips.append(_first_flips(pair, jax_calls, B) + t)
            first = np.minimum(first, flips[-1])
        held = first > t
        np.testing.assert_allclose(tl[held], jl[held], **_bf16_tol(jl), err_msg=f"step {t}")
    assert sum(int((f < 10**8).sum()) for f in flips) <= MAX_ROUTE_FLIPS, flips


@pytest.mark.parametrize("dtype", ["f32", "bf16"])
@pytest.mark.parametrize("arch", ARCHS)
def test_params_round_trip_bitwise(arch, dtype):
    pair = Pair(arch, dtype=dtype)
    want = jax.tree_util.tree_flatten_with_path(jax.tree.map(np.asarray, pair.params))[0]
    back = jax.tree_util.tree_flatten_with_path(to_reference_params(pair.tm))[0]
    assert [p for p, _ in back] == [p for p, _ in want]
    for (path, a), (_, b) in zip(back, want):
        assert a.dtype == b.dtype and a.shape == b.shape, path
        np.testing.assert_array_equal(a.view(np.uint8), b.view(np.uint8), err_msg=str(path))


def test_moe_layer_drops_tokens_as_the_reference():
    """A capacity small enough that tokens drop (64 tokens a group, top-2 of
    4 experts, capacity factor 0.5: 16 slots an expert against 32 choices
    on average): the outputs, the aux loss and which choices are kept equal
    the JAX package's; over two token groups as well."""
    cfg = get_config("granite-moe-1b-a400m").reduced()
    params = jzoo.init_params(jax_get_config("granite-moe-1b-a400m").reduced(), jax.random.PRNGKey(4))
    p = jax.tree.map(lambda a: np.asarray(a[0]), params["layers"]["moe"])
    tp = {k: _t(v) for k, v in p.items()}
    x = np.random.default_rng(4).standard_normal((2, 32, cfg.d_model)).astype(np.float32)
    kw = dict(n_experts=cfg.n_experts, top_k=cfg.top_k, capacity_factor=0.5)
    for groups in (1, 2):
        want_y, want_aux = jmoe.moe_layer(jnp.asarray(x), p, n_token_groups=groups, **kw)
        routes = []
        got_y, got_aux = moe.moe_layer(_t(x), tp, n_token_groups=groups, routes=routes, **kw)
        np.testing.assert_allclose(got_y.numpy(), np.asarray(want_y), **F32)
        np.testing.assert_allclose(float(got_aux), float(want_aux), **F32)
        # the drops happened: some token lost a choice, so its output is not
        # the full top-k mixture (a zero row where both choices dropped)
        C = moe.moe_capacity(64 // groups, cfg.n_experts, cfg.top_k, 0.5)
        counts = torch.bincount(routes[0].reshape(groups, -1)[0], minlength=cfg.n_experts)
        assert C == 16 // groups
        assert int(counts.max()) > C, (counts, C)
        full_y, _ = moe.moe_layer(_t(x), tp, n_token_groups=groups, **{**kw, "capacity_factor": 4.0})
        assert not torch.allclose(got_y, full_y)


@pytest.mark.parametrize("S_", [150, 64])
def test_rwkv6_time_mix_across_chunks(S_):
    """The two-level scan at S = 150 (chunks of 64: two full and one padded)
    and at exactly one chunk, against the JAX package and the port's
    float64 result."""
    cfg = get_config("rwkv6-3b").reduced()
    params = jzoo.init_params(jax_get_config("rwkv6-3b").reduced(), jax.random.PRNGKey(5))
    p = jax.tree.map(lambda a: np.asarray(a[0]), params["layers"]["tm"])
    rng = np.random.default_rng(5)
    # a nonzero bonus u and decays spread over (0, 1)
    p = {**p, "u": (0.5 * rng.standard_normal(p["u"].shape)).astype(np.float32),
         "w0": rng.uniform(-3.0, 1.0, p["w0"].shape).astype(np.float32)}
    x = rng.standard_normal((2, S_, cfg.d_model)).astype(np.float32)
    H, hd = cfg.d_model // cfg.rwkv_head_dim, cfg.rwkv_head_dim
    want = np.asarray(jrwkv6.rwkv6_time_mix(jnp.asarray(x), p, n_heads=H, head_dim=hd))
    tp = {k: _t(v) for k, v in p.items()}
    got = rwkv6.rwkv6_time_mix(_t(x), tp, n_heads=H, head_dim=hd).numpy()
    np.testing.assert_allclose(got, want, **_module_tol(want))
    p64 = {k: v.double() for k, v in tp.items()}
    exact = rwkv6.rwkv6_time_mix(_t(x, torch.float64), p64, n_heads=H, head_dim=hd).numpy()
    assert np.abs(got - exact).max() <= _F64_SCALE * np.abs(exact).max()
    # in float64 the two-level scan gives the same sums at any chunk length
    other = rwkv6.rwkv6_time_mix(_t(x, torch.float64), p64, n_heads=H, head_dim=hd, chunk=16).numpy()
    assert np.abs(other - exact).max() <= F64_REL * np.abs(exact).max()
    # the recurrence one token at a time gives the same outputs
    state = torch.zeros((2, H, hd, hd))
    prev = torch.zeros((2, cfg.d_model))
    for t in range(S_):
        y, state = rwkv6.rwkv6_time_mix_step(_t(x[:, t]), prev, state, tp, n_heads=H, head_dim=hd)
        prev = _t(x[:, t])
        np.testing.assert_allclose(y.numpy(), want[:, t], **_module_tol(want), err_msg=f"t={t}")


@pytest.mark.parametrize("S_", [150, 128])
def test_mamba2_forward_across_chunks(S_):
    """The chunked SSD form at S = 150 (chunks of 128: one full and one
    padded) and at exactly one chunk, against the JAX package and the
    port's float64 result; the decode recurrence gives the same outputs."""
    cfg = get_config("zamba2-2.7b").reduced()
    params = jzoo.init_params(jax_get_config("zamba2-2.7b").reduced(), jax.random.PRNGKey(6))
    p = jax.tree.map(lambda a: np.asarray(a[0]), params["layers"]["mamba"])
    rng = np.random.default_rng(6)
    p = {**p, "A_log": rng.uniform(-2.0, 1.0, p["A_log"].shape).astype(np.float32),
         "dt_bias": rng.uniform(-2.0, 0.5, p["dt_bias"].shape).astype(np.float32)}
    u = rng.standard_normal((2, S_, cfg.d_model)).astype(np.float32)
    kw = dict(d_state=cfg.ssm_state, head_dim=cfg.ssm_head_dim)
    want = np.asarray(jmamba2.mamba2_forward(jnp.asarray(u), p, **kw))
    tp = {k: _t(v) for k, v in p.items()}
    got = mamba2.mamba2_forward(_t(u), tp, **kw).numpy()
    np.testing.assert_allclose(got, want, **_module_tol(want))
    p64 = {k: v.double() for k, v in tp.items()}
    exact = mamba2.mamba2_forward(_t(u, torch.float64), p64, **kw).numpy()
    assert np.abs(got - exact).max() <= _F64_SCALE * np.abs(exact).max()
    # in float64 the chunked SSD form gives the same sums at any chunk length
    other = mamba2.mamba2_forward(_t(u, torch.float64), p64, chunk=32, **kw).numpy()
    assert np.abs(other - exact).max() <= F64_REL * np.abs(exact).max()
    cache = mamba2.mamba2_init_cache(2, tp, conv_k=cfg.ssm_conv, **kw)
    for t in range(S_):
        y, cache = mamba2.mamba2_decode_step(_t(u[:, t : t + 1]), cache, tp, **kw)
        np.testing.assert_allclose(y.numpy()[:, 0], want[:, t], **_module_tol(want), err_msg=f"t={t}")


def test_hybrid_site_caches_after_decode_steps():
    """zamba2: after 5 decode steps every per-layer mamba state (conv
    history and SSM state, f32 in a bf16 model as well) and every shared
    attention site's k/v equal the JAX package's; the sites' caches differ
    from each other (each application of the one shared block has its own)."""
    for dtype in ("f32", "bf16"):
        pair = Pair("zamba2-2.7b", seed=7, dtype=dtype)
        toks, _, _ = pair.batch(B, 5)
        jc, tc = pair.caches(B, CACHE, 0)
        assert tc["mamba"]["conv"].dtype == tc["mamba"]["ssm"].dtype == torch.float32
        assert tc["k"].shape[0] == pair.cfg.n_layers // pair.cfg.hybrid_attn_every == 2
        for t in range(5):
            jl, tl, jc, tc = pair.decode_both(toks[:, t : t + 1], jc, tc)
        _assert_caches_close(tc, jc, F32 if dtype == "f32" else _bf16_tol)
        assert not torch.equal(tc["k"][0], tc["k"][1])
        assert bool(tc["mamba"]["ssm"].abs().amax(dim=(1, 2, 3, 4)).gt(0).all())


def test_whisper_cross_cache_and_decode():
    """``fill_cross_cache`` writes each layer's ``ek``/``ev`` from the
    encoder's output, equal to the JAX package's products; decode against
    them equals the teacher-forced logits of ``Model.logits`` at every step
    (positions 0..S-1 from ``pos = 0``)."""
    pair = Pair("whisper-small", seed=8)
    toks, jb, tb = pair.batch(B, S)
    jc, tc = pair.caches(B, CACHE + S, 0)
    for name in ("ek", "ev"):
        assert tuple(tc[name].shape) == (pair.cfg.n_layers, B, pair.cfg.encoder_len, pair.cfg.n_kv, pair.cfg.hd)
        np.testing.assert_allclose(tc[name].numpy(), np.asarray(jc[name]), **F32)
    full = pair.tm.logits(tb)
    for t in range(S):
        logits, tc = pair.tm.decode(torch.from_numpy(toks[:, t : t + 1]), tc)
        torch.testing.assert_close(logits[:, 0], full[:, t], **F32)


def test_moe_prefill_and_decode_agree_without_drops():
    """granite-moe reduced at a capacity factor that drops nothing
    (``n_experts / top_k``: every expert can take every token): decode from
    ``pos = 0`` equals ``Model.logits`` at every position, and the routes
    recorded by the layers agree."""
    cfg = replace(get_config("granite-moe-1b-a400m").reduced(), capacity_factor=2.0)
    model = build_model(cfg, device="cpu", generator=torch.Generator().manual_seed(9))
    toks = torch.from_numpy(np.random.default_rng(9).integers(0, cfg.vocab, (B, 20)))
    for layer in model.layers:
        layer.routes = []
    full = model.logits({"tokens": toks})
    prefill_routes = [layer.routes.pop() for layer in model.layers]
    cache = model.init_cache(B, 20)
    cache["pos"] = torch.zeros((), dtype=torch.int32)
    for t in range(20):
        logits, cache = model.decode(toks[:, t : t + 1], cache)
        torch.testing.assert_close(logits[:, 0], full[:, t], **F32)
    for layer, want in zip(model.layers, prefill_routes):
        got = torch.cat(layer.routes, dim=1)
        assert torch.equal(got.sort(-1).values, want.sort(-1).values)
        layer.routes = None


@pytest.mark.parametrize("arch", ARCHS)
def test_float64_model_is_float64_throughout(arch):
    """A float64 model computes every step the reference keeps in f32 in
    float64 (``acc_dtype``): its decode from ``pos = 0`` equals its own
    ``Model.logits`` within ``F64_REL * max|logits|`` at every position,
    where one f32 step would cost about 1e-7 (moe at a capacity factor that
    drops nothing)."""
    cfg = get_config(arch).reduced()
    if cfg.family == "moe":
        cfg = replace(cfg, capacity_factor=cfg.n_experts / cfg.top_k)
    drawn = build_model(cfg, device="cpu", generator=torch.Generator().manual_seed(12))
    model = build_model(cfg, device="cpu", dtype=torch.float64)
    model.load_state_dict(drawn.state_dict())
    assert all(p.dtype == torch.float64 for p in model.parameters())
    rng = np.random.default_rng(12)
    toks = torch.from_numpy(rng.integers(0, cfg.vocab, (B, 20)))
    batch = {"tokens": toks}
    if cfg.is_encoder_decoder:
        batch["enc_embeds"] = torch.from_numpy(0.5 * rng.standard_normal((B, cfg.encoder_len, cfg.d_model)))
    full = model.logits(batch)
    assert full.dtype == torch.float64
    cache = model.init_cache(B, 20, torch.float64)
    if "pos" in cache:
        cache["pos"] = torch.zeros((), dtype=torch.int32)
    if cfg.is_encoder_decoder:
        model.fill_cross_cache(cache, batch["enc_embeds"])
    assert all(v.dtype == torch.float64 for _, v in _cache_leaves(cache) if v.is_floating_point())
    bound = F64_REL * float(full.abs().max())
    for t in range(20):
        logits, cache = model.decode(toks[:, t : t + 1], cache)
        torch.testing.assert_close(logits[:, 0], full[:, t], rtol=0, atol=bound)


def test_init_draws_each_familys_layout():
    """``Model.init`` draws the reference's layout: rwkv and mamba constants,
    the router f32 in a bf16 model, expert weights N(0, 1/fan_in) over their
    input width, and a model cut to fewer layers gets the first layers."""
    g = lambda: torch.Generator().manual_seed(11)  # noqa: E731
    rw = build_model(get_config("rwkv6-3b").reduced(), device="cpu", dtype=torch.bfloat16, generator=g())
    tm = rw.layers[0].tm
    assert float(tm["w0"][0]) == float(np.float32(-0.6)) and float(tm["mu_k"][0]) == 0.5 and not bool(tm["u"].any())
    assert tm["w0"].dtype == torch.float32 and rw.ln0["scale"].dtype == torch.float32
    lora_b = tm["w_lora_b"].float()
    assert abs(float(lora_b.std()) * tzoo.RWKV_LORA**0.5 / 0.1 - 1.0) < 0.1
    mb = build_model(get_config("zamba2-2.7b").reduced(), device="cpu", generator=g()).layers[1].mamba
    assert bool((mb["D_skip"] == 1).all()) and not bool(mb["A_log"].any()) and bool((mb["norm_scale"] == 1).all())
    gm_cfg = get_config("granite-moe-1b-a400m").reduced()
    gm = build_model(gm_cfg, device="cpu", dtype=torch.bfloat16, generator=g())
    ex = gm.layers[0].moe
    assert ex["router"].dtype == torch.float32 and ex["w_gate"].dtype == torch.bfloat16
    assert abs(float(ex["w_down"].float().std()) * gm_cfg.d_ff**0.5 - 1.0) < 0.1
    cut = build_model(replace(gm_cfg, n_layers=2), device="cpu", dtype=torch.bfloat16, generator=g())
    deep = dict(gm.named_parameters())
    for name, p in cut.named_parameters():
        assert torch.equal(p, deep[name]), name
