"""The port's training path (``repro_torch.train``) against the JAX
package's, on the CPU, at the reduced configs.

The JAX weights come from ``repro.models.zoo``'s ``Model.init(PRNGKey(seed))``
and are carried across by ``from_reference_params``; tokens, labels and
optimizer inputs come from ``np.random.default_rng``. Tolerances:

* Gradients of ``Model.loss`` against ``jax.value_and_grad``, per leaf:
  ``max|g_port - g_jax| <= GRAD_REL * max|g_jax|``. ``GRAD_REL`` is 4x the
  largest error measured over the 10 reduced archs (see its comment). A
  leaf whose reference gradient is all zero (zamba2's unused ``ln2``) must
  come out zero (the port's ``None``). Losses within ``LOSS_ABS``.
* ``adamw_update`` on identical gradients, state and parameters: ``m``,
  ``v``, ``master`` and f32 parameters within 2 f32 ulps (2**-22 ≈ 2.4e-7)
  of the entry or of the leaf's largest entry, whichever is larger
  (measured: 1.15e-7 of the entry unclipped; clipped, the clip scale
  carries the grad norm's 7.5e-8 relative difference, and ``m``, a
  difference of near-equal terms, then moves up to 2.8e-6 of a small entry
  but 3e-8 of its leaf's largest); bf16 parameters within one bf16 ulp
  (2**-7 relative, measured 0); ``step`` and ``lr`` equal; ``grad_norm``
  within 1e-6 relative (the packages sum the squares in another order).
* Ten steps of ``make_train_step`` against the reference's jitted step
  from the same weights and batches: each step's loss within
  ``TRAIN_LOSS_ABS``. Parameters are not compared after whole steps: where
  a gradient entry is within its error bound of zero, Adam's first steps
  turn its sign into a full ``lr`` move, so the packages' parameters part
  by up to ``2 lr`` there by design; the losses bound the effect.
* ``microbatches=2`` against 1: ``tests/test_train.py``'s tolerances (loss
  2e-3; parameters rtol 2e-2, atol 2e-4). ``remat=True`` against
  ``remat=False``: bitwise (the same operations recomputed).
* Checkpoints: every leaf bitwise in both directions; a file the port
  writes holds the reference's keys, dtypes and bytes.
* The copied data pipeline and expert placement: equal to the reference's.
"""

import copy
import json

import jax
import jax.numpy as jnp
import ml_dtypes
import numpy as np
import pytest
import torch

from repro.configs import get_config as jax_get_config
from repro.models import zoo as jzoo
from repro.train import AdamWConfig as JAdamWConfig
from repro.train import SyntheticTokenPipeline as JPipeline
from repro.train import adamw_init as jadamw_init
from repro.train import diffusion_assign_buckets as jassign
from repro.train import make_train_step as jmake_train_step
from repro.train.checkpoint import load_train_state as jload_train_state
from repro.train.checkpoint import save_train_state as jsave_train_state
from repro.train.moe_balance import ExpertPlacement as JExpertPlacement
from repro.train.optimizer import adamw_update as jadamw_update
from repro_torch.configs import all_arch_ids, get_config
from repro_torch.models import build_model
from repro_torch.models.convert import from_reference_params, to_reference_params
from repro_torch.models.zoo import DistContext
from repro_torch.train import (
    AdamWConfig,
    SyntheticTokenPipeline,
    adamw_init,
    adamw_update,
    diffusion_assign_buckets,
    make_train_step,
)
from repro_torch.train.checkpoint import load_train_state, save_train_state
from repro_torch.train.moe_balance import ExpertPlacement

# gradients: 4x the largest per-leaf error relative to the leaf's max|g|
# measured over the 10 reduced archs at B = 2, S = 16 (7.4e-6, zamba2-2.7b's
# ``layers/mamba/conv_w``; rwkv6-3b 4.5e-6, the others 1.4e-6 to 3.0e-6)
GRAD_REL = 3e-5
# the losses: 10x the largest difference measured (9.5e-7, whisper-small)
LOSS_ABS = 1e-5
ULP = 2.5e-7
BF16_ULP = dict(rtol=2**-7, atol=0)
# ten steps of olmo-1b reduced (lr 3e-3, warmup 10): 4x the largest loss
# difference measured (9.5e-7 at step 6, two f32 ulps of a loss of 5.4)
TRAIN_LOSS_ABS = 4e-6
# the families, one arch each, for the remat and checkpoint legs
FAMILY_ARCHS = ["qwen2-0.5b", "granite-moe-1b-a400m", "rwkv6-3b", "zamba2-2.7b", "whisper-small"]


@pytest.fixture(autouse=True, scope="module")
def _one_intra_op_thread():
    """One intra-op thread, so that parallel test workers share the host."""
    before = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(before)


def _leaves(tree) -> dict:
    return {jax.tree_util.keystr(k): np.asarray(v) for k, v in jax.tree_util.tree_flatten_with_path(tree)[0]}


class Pair:
    """One reduced arch in both packages, with the same weights."""

    def __init__(self, arch: str, seed: int = 0, dtype=jnp.float32, remat: bool = True):
        self.cfg = get_config(arch).reduced()
        self.jcfg = jax_get_config(arch).reduced()
        self.jm = jzoo.build_model(self.jcfg, jzoo.DistContext(remat=False))
        self.params = self.jm.init(jax.random.PRNGKey(seed), dtype)
        self.tm = from_reference_params(self.cfg, jax.tree.map(np.asarray, self.params), device="cpu")
        self.tm.dist = DistContext(remat=remat)
        self.rng = np.random.default_rng(seed + 1)

    def batch(self, n: int, seq: int):
        toks = self.rng.integers(0, self.cfg.vocab, (n, seq)).astype(np.int32)
        lab = self.rng.integers(0, self.cfg.vocab, (n, seq)).astype(np.int32)
        lab[:, -2:] = -1
        b = {"tokens": toks, "labels": lab}
        if self.cfg.m_rope:
            b["frontend_embeds"] = (0.01 * self.rng.standard_normal((n, seq, self.cfg.d_model))).astype(np.float32)
            p1 = np.arange(seq)[None].repeat(n, 0)
            b["positions"] = np.stack([p1, p1 // 2, p1 // 3], axis=1).astype(np.int32)
        if self.cfg.is_encoder_decoder:
            b["enc_embeds"] = (0.5 * self.rng.standard_normal((n, self.cfg.encoder_len, self.cfg.d_model))
                               ).astype(np.float32)
        return {k: jnp.asarray(v) for k, v in b.items()}, {k: torch.from_numpy(v) for k, v in b.items()}


def _port_grads(model) -> dict:
    """The port's gradients as the reference's tree, ``None`` as zeros."""
    return to_reference_params({n: (p.grad if p.grad is not None else torch.zeros_like(p))
                                for n, p in model.named_parameters()})


@pytest.mark.parametrize("arch", all_arch_ids())
def test_grads_match_jax_value_and_grad(arch):
    """``Model.loss(batch).backward()`` (remat on) against
    ``jax.value_and_grad(model.loss)`` on the same weights and batch."""
    pair = Pair(arch)
    jb, tb = pair.batch(2, 16)
    (jloss, _), jgrads = jax.jit(jax.value_and_grad(pair.jm.loss, has_aux=True))(pair.params, jb)
    loss, _ = pair.tm.loss(tb)
    loss.backward()
    assert abs(float(loss.detach()) - float(jloss)) <= LOSS_ABS, (float(loss.detach()), float(jloss))
    want, got = _leaves(jgrads), _leaves(_port_grads(pair.tm))
    assert want.keys() == got.keys()
    for key, w in want.items():
        scale = float(np.abs(w).max())
        err = float(np.abs(got[key].astype(np.float64) - w).max())
        assert err <= GRAD_REL * scale, f"{arch} {key}: {err:.3e} against max|g| {scale:.3e}"
        if scale == 0:
            assert pair.tm.get_parameter(_port_name(key)).grad is None, key


def _port_name(keystr: str) -> str:
    """A reference leaf ``['final_ln']['scale']`` of an unstacked tree as
    the port's parameter name (row 0 of a stacked one)."""
    parts = [p.strip("'") for p in keystr.strip("[]").split("][")]
    return ".".join([parts[0], "0", *parts[1:]] if parts[0] in ("layers", "encoder", "cross") else parts)


def _opt_inputs(rng, dtype: str, clipped: bool):
    shapes = {"a": (4, 8), "b": (16,), "c": (3, 5), "unused": (6,)}
    params = {k: rng.standard_normal(s).astype(np.float32) for k, s in shapes.items()}
    state = {
        "step": np.int32(7),
        "master": {k: (v + 1e-3 * rng.standard_normal(v.shape)).astype(np.float32) for k, v in params.items()},
        "m": {k: 0.01 * rng.standard_normal(s).astype(np.float32) for k, s in shapes.items()},
        "v": {k: 1e-4 * rng.random(s).astype(np.float32) for k, s in shapes.items()},
    }
    grads = {k: (100.0 if clipped else 0.01) * rng.standard_normal(s).astype(np.float32) for k, s in shapes.items()}
    grads["unused"] = np.zeros(shapes["unused"], np.float32)
    if dtype == "bf16":
        params = {k: v.astype(ml_dtypes.bfloat16) for k, v in params.items()}
        grads = {k: v.astype(ml_dtypes.bfloat16) for k, v in grads.items()}
    return params, state, grads


def _torch(a: np.ndarray) -> torch.Tensor:
    if a.dtype == ml_dtypes.bfloat16:
        return torch.from_numpy(a.view(np.int16)).view(torch.bfloat16)
    return torch.from_numpy(np.array(a))


@pytest.mark.parametrize("clipped", [False, True], ids=["unclipped", "clipped"])
@pytest.mark.parametrize("dtype", ["f32", "bf16"])
def test_adamw_update_matches_reference(dtype, clipped):
    """Identical gradients, state and parameters: the reference's jitted
    ``adamw_update`` and the port's, with one leaf whose gradient is zero
    there and ``None`` here (decay still moves it)."""
    params, state, grads = _opt_inputs(np.random.default_rng(3), dtype, clipped)
    cfg = dict(lr=1e-2, warmup_steps=20)
    jp, js, jstats = jax.jit(lambda g, s, p: jadamw_update(g, s, p, JAdamWConfig(**cfg)))(
        {k: jnp.asarray(v) for k, v in grads.items()}, jax.tree.map(jnp.asarray, state),
        {k: jnp.asarray(v) for k, v in params.items()})
    tparams = {k: _torch(v) for k, v in params.items()}
    tstate = {"step": torch.tensor(7, dtype=torch.int32),
              **{k: {n: torch.from_numpy(v.copy()) for n, v in state[k].items()} for k in ("master", "m", "v")}}
    tgrads = {k: _torch(v) for k, v in grads.items()}
    tgrads["unused"] = None
    out, ts, tstats = adamw_update(tgrads, tstate, tparams, AdamWConfig(**cfg))
    assert out["a"] is tparams["a"] and int(ts["step"]) == int(js["step"]) == 8
    assert (float(tstats["grad_norm"]) > 1.0) == clipped
    np.testing.assert_allclose(float(tstats["grad_norm"]), float(jstats["grad_norm"]), rtol=1e-6)
    assert float(tstats["lr"]) == float(jstats["lr"])
    def ulps(want):
        return dict(rtol=ULP, atol=ULP * float(np.abs(want).max()))

    for k in ("m", "v", "master"):
        for n in params:
            want = np.asarray(js[k][n])
            np.testing.assert_allclose(ts[k][n].numpy(), want, **ulps(want), err_msg=f"{k}/{n}")
    for n in params:
        want = np.asarray(jp[n].astype(jnp.float32))
        np.testing.assert_allclose(out[n].float().numpy(), want, **(BF16_ULP if dtype == "bf16" else ulps(want)),
                                   err_msg=n)
    assert not np.array_equal(ts["master"]["unused"].numpy(), state["master"]["unused"])


def test_adamw_applies_weight_decay_and_clip():
    """The port of ``tests/test_train.py``'s leg of the same name."""
    params = {"w": torch.ones((4, 4))}
    opt = adamw_init(params)
    grads = {"w": torch.full((4, 4), 100.0)}  # exceeds clip
    cfg = AdamWConfig(lr=1e-2, grad_clip=1.0, weight_decay=0.1, warmup_steps=1)
    new_params, new_opt, stats = adamw_update(grads, opt, params, cfg)
    assert float(stats["grad_norm"]) > 1.0
    assert float(new_params["w"].abs().max()) < 1.0  # moved down
    assert int(new_opt["step"]) == 1


def _jax_steps(pair: Pair, batches, microbatches: int, **cfg):
    step = jax.jit(jmake_train_step(pair.jm, JAdamWConfig(**cfg), microbatches=microbatches))
    params, opt, losses = pair.params, jadamw_init(pair.params), []
    for b in batches:
        params, opt, m = step(params, opt, {k: jnp.asarray(v) for k, v in b.items()})
        losses.append(float(m["loss"]))
    return params, opt, losses


def _port_steps(model, batches, microbatches: int, opt=None, **cfg):
    step = make_train_step(model, AdamWConfig(**cfg), microbatches=microbatches)
    opt, losses = opt or adamw_init(model), []
    for b in batches:
        opt, m = step(opt, {k: torch.from_numpy(v) for k, v in b.items()})
        losses.append(float(m["loss"]))
    assert set(m) == {"loss", "grad_norm", "lr"}
    return opt, losses


def test_ten_train_steps_track_the_reference():
    """olmo-1b reduced, ``tests/test_train.py``'s optimizer settings: the
    port's steps against the reference's jitted ones on the same batches."""
    pair = Pair("olmo-1b", remat=False)
    pipe = SyntheticTokenPipeline(vocab=pair.cfg.vocab, seq_len=32, global_batch=8)
    batches = list(pipe.structured_batches(10))
    _, _, want = _jax_steps(pair, batches, 1, lr=3e-3, warmup_steps=10)
    _, got = _port_steps(pair.tm, batches, 1, lr=3e-3, warmup_steps=10)
    np.testing.assert_allclose(got, want, rtol=0, atol=TRAIN_LOSS_ABS)
    assert got[-1] < got[0]


def test_loss_decreases_on_structured_data():
    """The port of ``tests/test_train.py``'s leg of the same name."""
    cfg = get_config("olmo-1b").reduced()
    model = build_model(cfg, DistContext(remat=False), device="cpu", generator=torch.Generator().manual_seed(0))
    pipe = SyntheticTokenPipeline(vocab=cfg.vocab, seq_len=32, global_batch=8)
    _, losses = _port_steps(model, pipe.structured_batches(25), 1, lr=3e-3, warmup_steps=10)
    assert losses[-1] < losses[0] - 0.5, (losses[0], losses[-1])


@pytest.mark.parametrize("arch", ["olmo-1b", "granite-moe-1b-a400m"])
def test_microbatch_accumulation_matches_full_batch(arch):
    """The port of ``tests/test_train.py``'s leg of the same name, with its
    tolerances; and the microbatched step against the reference's. A moe
    arch's expert capacity and balance loss follow the split, so its 1- and
    2-microbatch losses differ in the reference too (by 0.029 here): each
    is held against the reference's at the same count instead."""
    pair = Pair(arch, remat=False)
    batch = next(SyntheticTokenPipeline(vocab=pair.cfg.vocab, seq_len=16, global_batch=4).batches(1))
    m1, m2 = pair.tm, copy.deepcopy(pair.tm)
    _, (l1,) = _port_steps(m1, [batch], 1, lr=1e-3)
    _, (l2,) = _port_steps(m2, [batch], 2, lr=1e-3)
    if pair.cfg.family == "moe":
        _, _, (jl1,) = _jax_steps(pair, [batch], 1, lr=1e-3)
        assert abs(l1 - jl1) <= LOSS_ABS
    else:
        assert abs(l1 - l2) < 2e-3
    for a, c in zip(m1.parameters(), m2.parameters()):
        np.testing.assert_allclose(a.detach().numpy(), c.detach().numpy(), rtol=2e-2, atol=2e-4)
    _, _, (jl2,) = _jax_steps(pair, [batch], 2, lr=1e-3)
    assert abs(l2 - jl2) <= LOSS_ABS


@pytest.mark.parametrize("arch", FAMILY_ARCHS)
def test_remat_gives_the_same_gradients_and_step(arch):
    """Each family with ``remat`` on and off: every gradient and one whole
    step's parameters and state bitwise equal."""
    cfg = get_config(arch).reduced()
    pair = Pair(arch)
    _, tb = pair.batch(2, 16)
    models = {}
    for remat in (True, False):
        models[remat] = build_model(cfg, DistContext(remat=remat), device="cpu")
        models[remat].load_state_dict(pair.tm.state_dict())
        models[remat].loss(tb)[0].backward()
    for (name, a), b in zip(models[True].named_parameters(), models[False].parameters()):
        assert (a.grad is None) == (b.grad is None), name
        assert a.grad is None or torch.equal(a.grad, b.grad), name
    opts = {}
    for remat, model in models.items():
        opts[remat], _ = make_train_step(model, AdamWConfig())(adamw_init(model), tb)
    for a, b in zip(models[True].parameters(), models[False].parameters()):
        assert torch.equal(a, b)
    for k in ("master", "m", "v"):
        assert all(torch.equal(opts[True][k][n], opts[False][k][n]) for n in opts[True][k])


def _two_jax_steps(pair: Pair):
    pipe = JPipeline(vocab=pair.cfg.vocab, seq_len=16, global_batch=4)
    return pipe, _jax_steps(pair, list(pipe.batches(2)), 1, lr=1e-3, warmup_steps=2)


def _port_state_trees(model, opt) -> tuple[dict, dict]:
    return to_reference_params(model), {"step": opt["step"].numpy(),
                                        **{k: to_reference_params(opt[k]) for k in ("master", "m", "v")}}


def _assert_trees_bitwise(got, want):
    got, want = _leaves(got), _leaves(want)
    assert got.keys() == want.keys()
    for k, w in want.items():
        assert got[k].dtype == w.dtype and got[k].tobytes() == w.tobytes(), k


@pytest.mark.parametrize("dtype", ["f32", "bf16"])
def test_checkpoint_written_by_jax_loads_bitwise_in_the_port(tmp_path, dtype):
    """The reference trains 2 steps and saves; the port loads every leaf
    bitwise into a zero model and a fresh state, and writes the same files
    back (keys, dtypes and bytes). The reference's own loader cannot read
    its bf16 leaves (``np.savez`` stores them as raw 2-byte values, which
    ``astype(bfloat16)`` refuses): the port takes those bytes as bf16."""
    pair = Pair("qwen2-0.5b", dtype=jnp.float32 if dtype == "f32" else jnp.bfloat16)
    _, (params, opt, _) = _two_jax_steps(pair)
    jsave_train_state(tmp_path / "jax", params=params, opt_state=opt, step=2, meta={"arch": "qwen2-0.5b"})
    model = build_model(pair.cfg, device="cpu", dtype=torch.float32 if dtype == "f32" else torch.bfloat16)
    model, state, meta = load_train_state(tmp_path / "jax", model, adamw_init(model))
    assert meta == {"step": 2, "arch": "qwen2-0.5b"}
    got_p, got_o = _port_state_trees(model, state)
    _assert_trees_bitwise(got_p, jax.tree.map(np.asarray, params))
    _assert_trees_bitwise(got_o, jax.tree.map(np.asarray, opt))
    save_train_state(tmp_path / "port", params=model, opt_state=state, step=2, meta={"arch": "qwen2-0.5b"})
    for name in ("params.npz", "opt_state.npz"):
        with np.load(tmp_path / "jax" / name) as a, np.load(tmp_path / "port" / name) as b:
            assert sorted(a.files) == sorted(b.files)
            for k in a.files:
                assert a[k].dtype == b[k].dtype and a[k].tobytes() == b[k].tobytes(), (name, k)
    assert json.loads((tmp_path / "port" / "meta.json").read_text()) == meta


@pytest.mark.parametrize("arch", FAMILY_ARCHS)
def test_checkpoint_written_by_the_port_loads_bitwise_in_jax_and_resumes(tmp_path, arch):
    """The port trains 2 steps and saves; the reference loads every leaf
    bitwise. The port restores into a zero model, and one step from the
    restored state equals one step from the live state, bitwise."""
    pair = Pair(arch)
    _, tb = pair.batch(4, 16)
    batch = {k: v.numpy() for k, v in tb.items()}
    opt, _ = _port_steps(pair.tm, [batch, batch], 1, lr=1e-3, warmup_steps=2)
    save_train_state(tmp_path, params=pair.tm, opt_state=opt, step=2)
    like = pair.jm.init(jax.random.PRNGKey(1))
    jparams, jopt, meta = jload_train_state(tmp_path, like, jadamw_init(like))
    assert meta == {"step": 2}
    want_p, want_o = _port_state_trees(pair.tm, opt)
    _assert_trees_bitwise(jax.tree.map(np.asarray, jparams), want_p)
    _assert_trees_bitwise(jax.tree.map(np.asarray, jopt), want_o)
    restored = build_model(pair.cfg, pair.tm.dist, device="cpu")
    restored, ropt, _ = load_train_state(tmp_path, restored, adamw_init(restored))
    opts = {}
    for key, model, state in (("live", pair.tm, opt), ("restored", restored, ropt)):
        opts[key], _ = _port_steps(model, [batch], 1, opt=state, lr=1e-3, warmup_steps=2)
    _assert_trees_bitwise(_port_state_trees(restored, opts["restored"]), _port_state_trees(pair.tm, opts["live"]))


def test_pipeline_batches_equal_the_reference():
    """The copied ``SyntheticTokenPipeline``: buckets, their diffusion
    assignment onto 4 ranks, and both kinds of batches."""
    kw = dict(vocab=512, seq_len=64, global_batch=16, nranks=4, seed=5)
    ours, theirs = SyntheticTokenPipeline(**kw), JPipeline(**kw)
    np.testing.assert_array_equal(ours.bucket_tokens, theirs.bucket_tokens)
    assert ours.assignment == theirs.assignment and ours.balance_iters == theirs.balance_iters
    assert ours.rank_load() == theirs.rank_load()
    for kind in ("batches", "structured_batches"):
        for a, b in zip(getattr(ours, kind)(3), getattr(theirs, kind)(3)):
            assert a.keys() == b.keys() and all(np.array_equal(a[k], b[k]) for k in a)


def test_expert_placement_history_equals_the_reference():
    """``examples/moe_diffusion_balance.py``'s loop (32 experts on 16 groups,
    8 drifting Zipf windows) on the copied ``ExpertPlacement``."""
    rng = np.random.default_rng(0)
    ours, theirs = ExpertPlacement(n_experts=32, n_groups=16), JExpertPlacement(n_experts=32, n_groups=16)
    for t in range(8):
        loads = (1.0 / (1.0 + (np.arange(32) + 7 * t) % 32) ** 1.2) * rng.lognormal(0.0, 0.25, 32)
        assert ours.rebalance(loads) == theirs.rebalance(loads)
    assert ours.history == theirs.history and ours.assignment == theirs.assignment
    np.testing.assert_array_equal(ours.permutation(), theirs.permutation())


def test_diffusion_bucket_assignment_balances():
    """The port of ``tests/test_train.py``'s leg of the same name."""
    rng = np.random.default_rng(0)
    weights = list(rng.pareto(1.5, 48) + 0.5)
    assign, iters = diffusion_assign_buckets(weights, 6)
    assert (assign, iters) == jassign(weights, 6)
    assert len(assign) == 48 and all(0 <= a < 6 for a in assign)
    loads = np.zeros(6)
    for w, a in zip(weights, assign):
        loads[a] += w
    # bounded by avg + the single largest bucket (granularity limit)
    assert loads.max() <= sum(weights) / 6 + max(weights) + 1e-9


def test_expert_placement_reduces_peak_load():
    """The port of ``tests/test_train.py``'s leg of the same name."""
    pl = ExpertPlacement(n_experts=16, n_groups=4)
    loads = np.asarray([10.0, 1, 1, 1, 1, 1, 1, 1, 1, 1, 1, 1, 1, 1, 1, 1])
    before = pl.group_loads(loads).max()
    pl.rebalance(loads)
    after = pl.group_loads(loads).max()
    assert after <= before
    assert after <= loads.sum() / 4 + loads.max()
    assert sorted(pl.permutation().tolist()) == list(range(16))


def test_train_step_refuses_a_batch_that_does_not_split():
    cfg = get_config("olmo-1b").reduced()
    model = build_model(cfg, device="cpu", generator=torch.Generator().manual_seed(0))
    batch = {"tokens": torch.zeros((3, 8), dtype=torch.int64), "labels": torch.zeros((3, 8), dtype=torch.int64)}
    with pytest.raises(ValueError, match="does not split into 2 microbatches"):
        make_train_step(model, AdamWConfig(), microbatches=2)(adamw_init(model), batch)
