"""The port's sharding layer (``repro_torch.sharding.specs``,
``repro_torch.launch.mesh``, the active ``DistContext`` and
``sharded_decode_attention``) against the JAX package's, on the CPU.

* Specs: every parameter, optimizer-state, batch and cache spec of the 10
  archs at full size, both layouts and ``fsdp=False``, on the single- and
  multi-pod meshes, equal to the reference's ``PartitionSpec`` leaf by
  leaf (the reference's rules applied to its ``jax.eval_shape`` trees, no
  compile). The port keys parameters by name and drops the leading layer
  entry of a stacked tree; each of its layer rows is held against it.
* Placements: on fake 256- and 512-rank meshes, every parameter's local
  shard equals each dimension divided by the product of its axes' sizes,
  by ``place`` and by torch's own ``distribute_tensor``.
* Collectives on gloo, real processes: the distributed flash-decode at 2
  and 4 ranks against the port's and the reference's ``decode_attention``
  over the whole cache (f32: rtol 3e-5, atol 3e-6; f64 within 1e-12);
  reduced qwen2-0.5b and granite-moe-1b-a400m on a (2, 2) mesh with an
  active context against the inactive one (loss and decode logits within
  the f32 tolerance, every gradient within 3e-5 of its leaf's max|g|), and
  the same on the 3-D meshes (2, 2, 1), (2, 1, 2) and (2, 2, 2); products
  and views placed by ``repro_torch.sharding.fixed_placements`` on 8 ranks
  against the whole tensors (f64, within 1e-12).
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch
from jax.sharding import PartitionSpec as P
from torch.distributed.tensor import distribute_tensor

from repro.configs import get_config as jax_get_config
from repro.models import zoo as jzoo
from repro.models.attention import decode_attention as jax_decode_attention
from repro.sharding import specs as jspecs
from repro.train.optimizer import adamw_init as jadamw_init
from repro_torch.configs import all_arch_ids, cells_for, get_config
from repro_torch.launch.mesh import fake_process_group, make_production_mesh, mesh_axis_sizes
from repro_torch.models import build_model
from repro_torch.models.attention import decode_attention
from repro_torch.models.convert import reference_path
from repro_torch.models.zoo import DistContext
from repro_torch.sharding.specs import (
    batch_pspecs,
    cache_pspecs,
    opt_state_pspecs,
    param_pspecs,
    place,
    to_placements,
)
from repro_torch.train import adamw_init
from torch_dist_workers import active_model_rank, fixed_placements_rank, flash_decode_rank, run_ranks

MESHES = {"single": (("data", "model"), {"data": 16, "model": 16}),
          "multi": (("pod", "data", "model"), {"pod": 2, "data": 16, "model": 16})}
F32 = dict(rtol=3e-5, atol=3e-6)
GRAD_REL = 3e-5


def _jax_leaves(tree) -> dict:
    """Reference spec tree -> {path of keys: spec as a tuple}."""
    flat = jax.tree_util.tree_flatten_with_path(tree, is_leaf=lambda x: isinstance(x, P))[0]
    return {tuple(k.key for k in path): tuple(spec) for path, spec in flat}


def _port_leaves(tree: dict, prefix: tuple = ()) -> dict:
    out = {}
    for k, v in tree.items():
        out.update(_port_leaves(v, (*prefix, k)) if isinstance(v, dict) else {(*prefix, k): v})
    return out


def _pad(spec: tuple, ndim: int) -> tuple:
    return tuple(spec) + (None,) * (ndim - len(spec))


@pytest.fixture(scope="module")
def reference_shapes():
    """Each arch's reference parameter and optimizer-state trees
    (``jax.eval_shape``), and the port's model on the meta device."""
    out = {}
    for arch in all_arch_ids():
        jm = jzoo.build_model(jax_get_config(arch), jzoo.DistContext())
        p_sds = jax.eval_shape(lambda m=jm: m.init(jax.random.PRNGKey(0), jnp.bfloat16))
        model = build_model(get_config(arch), device="meta", dtype=torch.bfloat16)
        out[arch] = (p_sds, jax.eval_shape(jadamw_init, p_sds), model)
    return out


def _assert_named_equal(port: dict, ref: dict, ref_sds: dict, named: dict, what: str) -> None:
    """The port's {name: spec} against the reference's {path: spec}: every
    name at its reference path (a stacked row without the layer entry), and
    every reference leaf reached."""
    reached = set()
    for name, t in named.items():
        path, row = reference_path(name)
        want = _pad(ref[path], len(ref_sds[path].shape))
        if row is not None:
            assert want[0] is None, (what, name, want)
            want = want[1:]
        assert port[name] == want, (what, name, port[name], want)
        assert len(port[name]) == t.dim()
        reached.add(path)
    assert reached == set(ref), (what, set(ref) ^ reached)


@pytest.mark.parametrize("mesh", sorted(MESHES))
@pytest.mark.parametrize("layout", ["tp-fsdp", "fsdp"])
def test_param_and_opt_specs_equal_the_reference(reference_shapes, mesh, layout):
    """All 10 archs at full size: parameter specs (``fsdp`` on and off) and
    optimizer-state specs leaf by leaf."""
    axes, sizes = MESHES[mesh]
    for arch, (p_sds, opt_sds, model) in reference_shapes.items():
        cfg, jcfg = get_config(arch), jax_get_config(arch)
        named = dict(model.named_parameters())
        ref_sds = {tuple(k.key for k in path): v for path, v in jax.tree_util.tree_flatten_with_path(p_sds)[0]}
        for fsdp in (True, False):
            want = _jax_leaves(jspecs.param_pspecs(jcfg, p_sds, axes, sizes, fsdp=fsdp, layout=layout))
            got = param_pspecs(cfg, model, axes, sizes, fsdp=fsdp, layout=layout)
            _assert_named_equal(got, want, ref_sds, named, f"{arch} params fsdp={fsdp}")
        opt = adamw_init(model)
        got = opt_state_pspecs(cfg, opt, axes, sizes, layout=layout)
        want = _jax_leaves(jspecs.opt_state_pspecs(jcfg, opt_sds, axes, sizes, layout=layout))
        assert got["step"] == want[("step",)] == ()
        for key in ("master", "m", "v"):
            sub = {path[1:]: spec for path, spec in want.items() if path[0] == key}
            _assert_named_equal(got[key], sub, ref_sds, opt[key], f"{arch} opt {key}")


@pytest.mark.parametrize("mesh", sorted(MESHES))
def test_batch_and_cache_specs_equal_the_reference(mesh):
    """Every cell's batch specs (both layouts) and every decode cell's cache
    specs, all 10 archs at full size."""
    axes, sizes = MESHES[mesh]
    for arch in all_arch_ids():
        cfg, jcfg = get_config(arch), jax_get_config(arch)
        model = build_model(cfg, device="meta", dtype=torch.bfloat16)
        for shape in cells_for(cfg):
            for layout in ("tp-fsdp", "fsdp"):
                want = jspecs.batch_pspecs(jcfg, shape, axes, layout=layout)
                got = batch_pspecs(cfg, shape, axes, layout=layout)
                assert got == {k: tuple(v) for k, v in want.items()}, (arch, shape.shape_id, layout)
            if shape.kind != "decode":
                continue
            c_sds = jax.eval_shape(lambda: jzoo.init_cache(jcfg, shape.global_batch, shape.seq_len, jnp.bfloat16))
            cache = model.init_cache(shape.global_batch, shape.seq_len, torch.bfloat16)
            want = _jax_leaves(jspecs.cache_pspecs(jcfg, shape, c_sds, axes, sizes))
            got = _port_leaves(cache_pspecs(cfg, shape, cache, axes, sizes))
            shapes = _port_leaves(cache)
            assert set(got) == set(want), (arch, shape.shape_id)
            for path, spec in want.items():
                assert got[path] == _pad(spec, shapes[path].dim()), (arch, shape.shape_id, path)


# -- the ports of tests/test_sharding.py's legs ------------------------------------

AXES, SIZES = MESHES["single"]


def _check_divisible(specs: dict, tensors: dict) -> None:
    for key, spec in specs.items():
        if isinstance(spec, dict):
            _check_divisible(spec, tensors[key])
            continue
        for dim, entry in zip(tensors[key].shape, spec):
            names = () if entry is None else entry if isinstance(entry, tuple) else (entry,)
            assert dim % int(np.prod([SIZES[n] for n in names] or [1])) == 0, (key, spec, tensors[key].shape)


def test_param_and_opt_specs_all_archs():
    for arch in all_arch_ids():
        cfg = get_config(arch)
        model = build_model(cfg, device="meta", dtype=torch.bfloat16)
        named = dict(model.named_parameters())
        specs = param_pspecs(cfg, model, AXES, SIZES)
        assert specs.keys() == named.keys()
        _check_divisible(specs, named)
        # big matrices must actually be sharded on the model axis
        assert any("model" in str(s) for s in specs.values()), arch
        opt = adamw_init(model)
        ospecs = opt_state_pspecs(cfg, opt, AXES, SIZES)
        for key in ("master", "m", "v"):
            _check_divisible(ospecs[key], opt[key])


def test_cache_specs_all_cells():
    for arch in all_arch_ids():
        cfg = get_config(arch)
        model = build_model(cfg, device="meta", dtype=torch.bfloat16)
        for shape in cells_for(cfg):
            if shape.kind != "decode":
                continue
            cache = model.init_cache(shape.global_batch, shape.seq_len, torch.bfloat16)
            specs = cache_pspecs(cfg, shape, cache, AXES, SIZES)
            assert _port_leaves(specs).keys() == _port_leaves(cache).keys()
            _check_divisible(specs, cache)
            if shape.global_batch == 1 and "k" in specs:
                # long-context: the KV sequence dim must be sharded on data
                assert "data" in str(specs["k"]), (arch, specs["k"])


def test_batch_specs():
    for arch in all_arch_ids():
        cfg = get_config(arch)
        for shape in cells_for(cfg):
            assert "tokens" in batch_pspecs(cfg, shape, AXES)


def test_wsc_is_identity_without_axes():
    dist = DistContext()
    x = torch.ones((4, 4))
    assert dist.wsc(x, "b.") is x


def test_wsc_refuses_a_plain_tensor_under_an_active_context():
    with pytest.raises(NotImplementedError, match="DTensor"):
        DistContext(batch_axes=("data",)).wsc(torch.ones((4, 4)), "b.")


# -- placements on fake meshes ----------------------------------------------------


def test_to_placements_keeps_the_mesh_order():
    with fake_process_group(8):
        mesh = torch.distributed.device_mesh.init_device_mesh("cpu", (2, 2, 2), mesh_dim_names=("pod", "data", "model"))
        assert [str(p) for p in to_placements((("pod", "data"), "model"), mesh)] == ["S(0)", "S(0)", "S(1)"]
        assert [str(p) for p in to_placements((None, ("data", "model")), mesh)] == ["R", "S(1)", "S(1)"]
        with pytest.raises(ValueError, match="order"):
            to_placements((("model", "data"),), mesh)


@pytest.mark.parametrize("multi_pod", [False, True], ids=["256", "512"])
def test_local_shards_on_the_production_mesh(multi_pod):
    """Every parameter of every arch (full size, meta) and every decode
    cache, placed by its spec: local shape = each dimension over the
    product of its axes' sizes, from ``place`` and from torch's
    ``distribute_tensor``."""
    with fake_process_group(512 if multi_pod else 256):
        mesh = make_production_mesh(multi_pod=multi_pod, device_type="cpu")
        axes, sizes = tuple(mesh.mesh_dim_names), mesh_axis_sizes(mesh)
        assert mesh.size() == (512 if multi_pod else 256)
        for arch in all_arch_ids():
            cfg = get_config(arch)
            model = build_model(cfg, device="meta", dtype=torch.bfloat16)
            tensors = dict(model.named_parameters())
            specs = param_pspecs(cfg, model, axes, sizes)
            for shape in cells_for(cfg):
                if shape.kind == "decode":
                    cache = model.init_cache(shape.global_batch, shape.seq_len, torch.bfloat16)
                    cspecs = _port_leaves(cache_pspecs(cfg, shape, cache, axes, sizes))
                    for path, t in _port_leaves(cache).items():
                        tensors[(shape.shape_id, *path)], specs[(shape.shape_id, *path)] = t, cspecs[path]
            for key, t in tensors.items():
                spec = specs[key]
                axes_of = [() if e is None else e if isinstance(e, tuple) else (e,) for e in spec]
                want = tuple(dim // int(np.prod([sizes[n] for n in names])) for dim, names in zip(t.shape, axes_of))
                assert tuple(place(t, spec, mesh).to_local().shape) == want, (arch, key, spec)
                assert tuple(distribute_tensor(t.detach(), mesh, to_placements(spec, mesh)).to_local().shape) == want


# -- collectives between real processes (gloo) --------------------------------------


@pytest.mark.parametrize("world", [2, 4])
def test_sharded_decode_attention_matches_the_whole_cache(tmp_path, world):
    rng = np.random.default_rng(world)
    B, T, H, Hkv, d = 2, 32, 4, 2, 16
    inputs = {"q": rng.standard_normal((B, 1, H, d)), "k": rng.standard_normal((B, T, Hkv, d)),
              "v": rng.standard_normal((B, T, Hkv, d))}
    got = run_ranks(flash_decode_rank, world, tmp_path, {k: torch.from_numpy(v) for k, v in inputs.items()})
    t32 = {k: torch.from_numpy(v.astype(np.float32)) for k, v in inputs.items()}
    t64 = {k: torch.from_numpy(v) for k, v in inputs.items()}
    np.testing.assert_allclose(got["f32"].numpy(), decode_attention(t32["q"], t32["k"], t32["v"]).numpy(), **F32)
    want_jax = jax_decode_attention(*(jnp.asarray(inputs[k].astype(np.float32)) for k in ("q", "k", "v")))
    np.testing.assert_allclose(got["f32"].numpy(), np.asarray(want_jax), **F32)
    np.testing.assert_allclose(got["f64"].numpy(), decode_attention(t64["q"], t64["k"], t64["v"]).numpy(),
                               rtol=0, atol=1e-12)


def _assert_matches_the_inactive_model(found: dict) -> None:
    for arch, f in found.items():
        assert f["loss_err"] <= F32["atol"] + F32["rtol"] * abs(f["loss"]), (arch, f)
        assert f["grad_rel"] <= GRAD_REL, (arch, f)
        assert f["decode_err"] <= F32["atol"] + F32["rtol"] * f["logits_max"], (arch, f)


def test_active_context_on_a_2x2_mesh_matches_the_inactive_model(tmp_path):
    """Reduced qwen2-0.5b and granite-moe-1b-a400m: the specs and ``wsc``
    compose into the same model (loss, gradients, 4 decode steps)."""
    found = run_ranks(active_model_rank, 4, tmp_path, ["qwen2-0.5b", "granite-moe-1b-a400m"])
    _assert_matches_the_inactive_model(found)


@pytest.mark.parametrize("shape, archs", [
    ((2, 2, 1), ["qwen2-0.5b", "granite-moe-1b-a400m"]),
    ((2, 1, 2), ["granite-20b", "granite-moe-1b-a400m"]),
    ((2, 2, 2), ["qwen2-0.5b"]),
], ids=["2x2x1", "2x1x2", "2x2x2"])
def test_active_context_on_a_3d_mesh_matches_the_inactive_model(tmp_path, shape, archs):
    """The same on ("pod", "data", "model") meshes, where ``mesh_scope``
    places products, views and pointwise operations by
    ``repro_torch.sharding.fixed_placements``: (2, 2, 1)
    shards the batch over "pod" and "data" at once; on (2, 1, 2) the heads
    (and, in the linear layers, the sequence) on "model" merge with the
    batch into strided shards, granite-20b's one kv head is cut from a
    replicated one, and the row-parallel products' partial sums are
    reduced inside the product; on (2, 2, 2) (8 ranks) both at once."""
    world = shape[0] * shape[1] * shape[2]
    _assert_matches_the_inactive_model(run_ranks(active_model_rank, world, tmp_path, archs, shape))


# name: (operands as (shape, placements a mesh axis), steps), the result's placements
FIXED_PLACEMENT_CASES = {
    "mm: rows on pod and data, b gathered on data, its columns on model": (
        ([(8, 6), "S0,S0,R"], [(6, 4), "R,S0,S1"]), [("@", 1, None)], ["S(0)", "S(0)", "S(1)"]),
    "mm: the contraction on three axes, the partial sums reduced": (
        ([(8, 8), "R,S1,S1"], [(8, 4), "S0,R,S0"]), [("@", 1, None)], ["R", "R", "R"]),
    "bmm: the batch on pod and data, the contraction on model": (
        ([(4, 3, 6), "S0,S0,S2"], [(4, 6, 5), "R,S0,S1"]), [("@", 1, None)], ["S(0)", "S(0)", "R"]),
    "bmm: heads merged into a batch on two axes (strided), split back": (
        ([(8, 4, 3, 6), "S0,S0,S1"], [(8, 4, 6, 5), "S0,S0,S1"]),
        [("view", (32, 3, 6)), ("@", 1, (32, 6, 5)), ("view", (8, 4, 3, 5))], ["S(0)", "S(0)", "S(1)"]),
    "bmm: a strided batch against a replicated operand, cut in its unmerged view": (
        ([(8, 4, 3, 6), "S0,S0,S1"], [(32, 6, 5), "R,R,R"]),
        [("view", (32, 3, 6)), ("@", 1, None), ("view", (8, 4, 3, 5))], ["S(0)", "S(0)", "S(1)"]),
    "view: a split the shard cannot follow (6 on 2 as (3, 2)) gathers it first": (
        ([(4, 6, 5), "S0,S0,S1"],), [("view", (4, 3, 2, 5))], ["S(0)", "S(0)", "R"]),
    "mm: one dimension on two axes merged with one on the third, split back": (
        ([(4, 4, 6), "S0,S0,S1"], [(6, 3), "R,R,R"]),
        [("view", (16, 6)), ("@", 1, None), ("view", (4, 4, 3))], ["S(0)", "S(0)", "S(1)"]),
}


def test_fixed_placements_on_a_2x2x2_mesh_match_the_whole_tensors(tmp_path):
    """``repro_torch.sharding.fixed_placements`` on 8 gloo ranks, in f64:
    products and views of real DTensors (strided shards from two batch
    axes, partial sums, a view whose shard must be gathered first) give
    the placements the rule names and, gathered, the products of the whole
    tensors within 1e-12 of their largest value."""
    cases = {name: (operands, steps) for name, (operands, steps, _) in FIXED_PLACEMENT_CASES.items()}
    found = run_ranks(fixed_placements_rank, 8, tmp_path, cases)
    for name, (_, _, placements) in FIXED_PLACEMENT_CASES.items():
        f = found[name]
        assert f["placements"] == placements, (name, f)
        assert f["err"] <= 1e-12 * f["scale"], (name, f)
