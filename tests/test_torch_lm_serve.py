"""The port's LM serving path (``repro_torch.models``, ``repro_torch.train``)
against the JAX package's, on the CPU, for every reduced dense / vlm arch.

The JAX weights come from ``repro.models.zoo.init_params(cfg, PRNGKey(seed))``
and are carried across by ``from_reference_params``; tokens and the vlm
stubs' inputs come from ``np.random.default_rng``. Tolerances:

* f32: logits, loss and decode logits within rtol 1e-5 / atol 1e-5 (the
  largest difference measured was 4.5e-6 on logits of magnitude 3.5);
  greedy ``serve_step`` tokens **identical** over 8 steps.
* bf16 (weights and cache): logits within 8 bf16 ulps of the largest logit,
  ``atol = 2**-5 * max|logits|`` with rtol 0. The frameworks round their
  bf16 products at different points and the differences grow through the
  layers: the largest measured was 0.0625 at a largest logit of 3.97
  (qwen2-vl-72b reduced), about half this bound.
* Parameters round-trip bitwise through ``to_reference_params``.
"""

from dataclasses import replace

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.configs import get_config as jax_get_config
from repro.models import zoo as jzoo
from repro.train.train_step import make_serve_step as jax_make_serve_step
from repro_torch.configs import all_arch_ids, get_config
from repro_torch.models import Model, build_model
from repro_torch.models.convert import from_reference_params, to_reference_params
from repro_torch.models import zoo as tzoo
from repro_torch.models.zoo import DistContext
from repro_torch.train import make_serve_step

torch.set_num_threads(1)

ARCHS = ["olmo-1b", "qwen2-0.5b", "yi-9b", "granite-20b", "qwen2-vl-72b"]
F32 = dict(rtol=1e-5, atol=1e-5)
B, S, CACHE = 2, 12, 8


@pytest.fixture(autouse=True)
def _no_autograd():
    """Serving builds no autograd graph (``serve_step`` and ``Model.decode``
    run under ``torch.no_grad``); neither does a prefill here, though the
    parameters take gradients."""
    with torch.no_grad():
        yield


def _bf16_tol(want: np.ndarray) -> dict:
    return dict(rtol=0, atol=2**-5 * float(np.abs(want).max()))


class Pair:
    """One reduced arch in both packages, with the same weights."""

    def __init__(self, arch: str, seed: int = 0, dtype: str = "f32"):
        self.cfg = get_config(arch).reduced()
        self.jcfg = jax_get_config(arch).reduced()
        self.jdt, self.tdt = (jnp.float32, torch.float32) if dtype == "f32" else (jnp.bfloat16, torch.bfloat16)
        self.jm = jzoo.build_model(self.jcfg, jzoo.DistContext(remat=False))
        self.params = self.jm.init(jax.random.PRNGKey(seed), self.jdt)
        self.tm = from_reference_params(self.cfg, jax.tree.map(np.asarray, self.params), device="cpu")
        self.rng = np.random.default_rng(seed)
        self._decode = jax.jit(lambda p, t, c, e: self.jm.decode(p, t, c, e))

    def batch(self, n: int, seq: int, labels: bool = False):
        toks = self.rng.integers(0, self.cfg.vocab, (n, seq)).astype(np.int32)
        jb, tb = {"tokens": jnp.asarray(toks)}, {"tokens": torch.from_numpy(toks)}
        if labels:
            lab = self.rng.integers(0, self.cfg.vocab, (n, seq)).astype(np.int32)
            lab[:, -3:] = -1
            lab[0, 1] = -1
            jb["labels"], tb["labels"] = jnp.asarray(lab), torch.from_numpy(lab)
        if self.cfg.m_rope:
            fe = (0.01 * self.rng.standard_normal((n, seq, self.cfg.d_model))).astype(np.float32)
            p1 = np.arange(seq)[None].repeat(n, 0)
            pos = np.stack([p1, p1 // 2, p1 // 3], axis=1).astype(np.int32)
            jb.update(frontend_embeds=jnp.asarray(fe), positions=jnp.asarray(pos))
            tb.update(frontend_embeds=torch.from_numpy(fe), positions=torch.from_numpy(pos))
        return toks, jb, tb

    def extras(self, n: int):
        if not self.cfg.m_rope:
            return None, None
        fe = (0.01 * self.rng.standard_normal((n, 1, self.cfg.d_model))).astype(np.float32)
        return {"frontend_embeds": jnp.asarray(fe)}, {"frontend_embeds": torch.from_numpy(fe)}

    def caches(self, n: int, cache_len: int, pos0: int | None):
        jc = self.jm.init_cache(n, cache_len, self.jdt)
        tc = self.tm.init_cache(n, cache_len, self.tdt)
        if pos0 is not None:
            jc["pos"] = jnp.zeros((), jnp.int32) + pos0
            tc["pos"] = torch.tensor(pos0, dtype=torch.int32)
        return jc, tc

    def decode_both(self, token: np.ndarray, jc, tc):
        je, te = self.extras(token.shape[0])
        jl, jc = self._decode(self.params, jnp.asarray(token), jc, je)
        tl, tc = self.tm.decode(torch.from_numpy(token), tc, te)
        return np.asarray(jl.astype(jnp.float32)), tl.float().numpy(), jc, tc


@pytest.mark.parametrize("arch", ARCHS)
def test_model_matches_reference(arch):
    """Logits, loss, and 6 decode steps from the default cache (``pos =
    cache_len``: the first step writes slot 0 at rope position
    ``cache_len`` and attends every slot, the zero ones too) and from
    ``pos = 0``, each against the JAX package."""
    pair = Pair(arch)
    toks, jb, tb = pair.batch(B, S, labels=True)
    want = np.asarray(jax.jit(pair.jm.logits)(pair.params, jb))
    got = pair.tm.logits(tb)
    assert got.shape == (B, S, pair.cfg.vocab) and got.dtype == torch.float32
    np.testing.assert_allclose(got.numpy(), want, **F32)

    jloss, jmetrics = jax.jit(pair.jm.loss)(pair.params, jb)
    tloss, tmetrics = pair.tm.loss(tb)
    np.testing.assert_allclose(float(tloss), float(jloss), **F32)
    assert float(tmetrics["tokens"]) == float(jmetrics["tokens"])

    for pos0 in (None, 0):
        jc, tc = pair.caches(B, CACHE, pos0)
        for t in range(6):
            jl, tl, jc, tc = pair.decode_both(toks[:, t : t + 1], jc, tc)
            assert tl.shape == (B, 1, pair.cfg.vocab)
            np.testing.assert_allclose(tl, jl, **F32, err_msg=f"pos0={pos0} step {t}")
        assert int(tc["pos"]) == int(jc["pos"])
        np.testing.assert_allclose(tc["k"].numpy(), np.asarray(jc["k"]), **F32)
        np.testing.assert_allclose(tc["v"].numpy(), np.asarray(jc["v"]), **F32)


@pytest.mark.parametrize("arch", ARCHS)
def test_serve_step_tokens_equal_reference(arch):
    """Greedy tokens identical to the JAX package's over 8 steps, each step
    fed the previous step's token, from a cache shorter than the run (the
    ring wraps)."""
    pair = Pair(arch, seed=1)
    jstep = jax.jit(jax_make_serve_step(pair.jm))
    tstep = make_serve_step(pair.tm)
    tok = pair.rng.integers(0, pair.cfg.vocab, (3, 1)).astype(np.int32)
    jt, tt = jnp.asarray(tok), torch.from_numpy(tok)
    jc, tc = pair.caches(3, 6, None)
    jseq, tseq = [], []
    for _ in range(8):
        je, te = pair.extras(3)
        jt, jc = jstep(pair.params, jt, jc, je)
        tt, tc = tstep(tt, tc, te)
        assert tt.dtype == torch.int32 and tt.shape == (3, 1)
        jseq.append(np.asarray(jt))
        tseq.append(tt.numpy())
    np.testing.assert_array_equal(np.concatenate(tseq, 1), np.concatenate(jseq, 1))


def test_loss_chunks_and_ignored_labels_match_reference():
    """``logit_chunk = 8`` over S = 20: two full chunks and a padded one,
    with -1 labels inside and at the end."""
    pair = Pair("qwen2-0.5b", seed=2)
    _, jb, tb = pair.batch(B, 20, labels=True)
    jloss, jm = jzoo.loss_fn(pair.jcfg, pair.params, jb, pair.jm.dist, logit_chunk=8)
    tloss, tm = tzoo.loss_fn(pair.tm, tb, logit_chunk=8)
    np.testing.assert_allclose(float(tloss), float(jloss), **F32)
    np.testing.assert_allclose(float(tm["ce"]), float(jm["ce"]), **F32)
    assert float(tm["tokens"]) == float(jm["tokens"]) == float((tb["labels"] >= 0).sum())
    # one chunk of everything gives the same loss
    np.testing.assert_allclose(float(tzoo.loss_fn(pair.tm, tb, logit_chunk=20)[0]), float(tloss), **F32)


@pytest.mark.parametrize("arch", ["qwen2-0.5b", "granite-20b", "qwen2-vl-72b"])
def test_bf16_model_matches_reference(arch):
    """bf16 weights and cache (norm params stay f32 on both sides)."""
    pair = Pair(arch, seed=3, dtype="bf16")
    assert pair.tm.embed.dtype == torch.bfloat16
    assert pair.tm.layers[0].ln1["scale"].dtype == torch.float32
    toks, jb, tb = pair.batch(B, S)
    want = np.asarray(jax.jit(pair.jm.logits)(pair.params, jb).astype(jnp.float32))
    got = pair.tm.logits(tb)
    assert got.dtype == torch.bfloat16
    np.testing.assert_allclose(got.float().numpy(), want, **_bf16_tol(want))
    jc, tc = pair.caches(B, CACHE, 0)
    for t in range(6):
        jl, tl, jc, tc = pair.decode_both(toks[:, t : t + 1], jc, tc)
        np.testing.assert_allclose(tl, jl, **_bf16_tol(jl), err_msg=f"step {t}")


@pytest.mark.parametrize("dtype", ["f32", "bf16"])
@pytest.mark.parametrize("arch", ["olmo-1b", "qwen2-0.5b", "granite-20b"])
def test_params_round_trip_bitwise(arch, dtype):
    pair = Pair(arch, dtype=dtype)
    want = jax.tree_util.tree_flatten_with_path(jax.tree.map(np.asarray, pair.params))[0]
    back = jax.tree_util.tree_flatten_with_path(to_reference_params(pair.tm))[0]
    assert [p for p, _ in back] == [p for p, _ in want]
    for (path, a), (_, b) in zip(back, want):
        assert a.dtype == b.dtype and a.shape == b.shape, path
        np.testing.assert_array_equal(a.view(np.uint8), b.view(np.uint8), err_msg=str(path))


def test_init_draws_the_reference_layout():
    """Norm params f32 and QKV biases zero in the model dtype; one seed gives
    the same weights to a model cut to fewer layers (its first layers)."""
    cfg = get_config("qwen2-0.5b").reduced()
    deep = build_model(cfg, device="cpu", dtype=torch.bfloat16, generator=torch.Generator().manual_seed(7))
    cut = build_model(replace(cfg, n_layers=2), device="cpu", dtype=torch.bfloat16,
                      generator=torch.Generator().manual_seed(7))
    layer = deep.layers[0]
    assert layer.ln1["scale"].dtype == torch.float32 and bool((layer.ln1["scale"] == 1).all())
    assert layer.attn["bq"].dtype == torch.bfloat16 and not bool(layer.attn["bq"].any())
    for name, w in (("wq", layer.attn["wq"]), ("w_down", layer.mlp["w_down"])):
        assert abs(float(w.float().std()) * w.shape[0] ** 0.5 - 1.0) < 0.1, name
    assert abs(float(deep.embed.float().std()) / 0.02 - 1.0) < 0.05
    cut_params = dict(cut.named_parameters())
    for name, p in deep.named_parameters():
        if name in cut_params:
            assert torch.equal(p, cut_params[name]), name
    assert set(cut_params) < set(dict(deep.named_parameters()))


@pytest.mark.parametrize("arch", all_arch_ids())
def test_every_arch_builds_and_decodes_a_step(arch):
    """``build_model`` builds every family at its reduced config on the CPU
    and runs one decode step from a fresh cache: finite logits of the
    vocabulary's width and a cache of the same structure."""
    cfg = get_config(arch).reduced()
    model = build_model(cfg, device="cpu", generator=torch.Generator().manual_seed(0))
    assert model.cfg.family == get_config(arch).family
    cache = model.init_cache(2, 8)
    keys = sorted(cache)
    logits, cache = model.decode(torch.full((2, 1), 7, dtype=torch.int32), cache)
    assert logits.shape == (2, 1, cfg.vocab) and bool(torch.isfinite(logits).all())
    assert sorted(cache) == keys


def test_build_model_without_a_card_raises(monkeypatch):
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    with pytest.raises(RuntimeError, match="no CUDA device"):
        build_model("qwen2-0.5b")


def test_active_dist_context_and_sampling_are_refused():
    cfg = get_config("qwen2-0.5b").reduced()
    model = build_model(cfg, DistContext(model_axis="model", model_size=2), device="cpu",
                        generator=torch.Generator().manual_seed(0))
    with pytest.raises(NotImplementedError, match="sharding"):
        model.logits({"tokens": torch.zeros((1, 4), dtype=torch.int64)})
    with pytest.raises(NotImplementedError, match="greedily"):
        make_serve_step(model, greedy=False)
    assert isinstance(model, Model) and all(p.requires_grad for p in model.parameters())
