"""The reference's side of the port's dry-run tests: each rank's argument
bytes of a cell under the JAX package's specs applied to its
``jax.eval_shape`` trees (each leaf's shape divided by its axes' sizes,
times its itemsize), its analytic model, and the cells cut for the CPU."""

from dataclasses import replace

import jax
import jax.numpy as jnp
import numpy as np
from jax.sharding import PartitionSpec as P

from repro.launch import perf_model as jperf
from repro.launch.inputs import input_specs as jax_input_specs
from repro.models import zoo as jzoo
from repro.sharding import specs as jspecs
from repro.train.optimizer import adamw_init as jadamw_init

__all__ = ["assert_bytes", "assert_traced_cell", "cut"]


def _spec_bytes(spec_tree, sds_tree, sizes: dict) -> int:
    """Per-rank bytes of the reference's trees under its specs."""
    specs = jax.tree_util.tree_leaves(spec_tree, is_leaf=lambda x: isinstance(x, P))
    leaves = jax.tree_util.tree_leaves(sds_tree)
    assert len(specs) == len(leaves)
    total = 0
    for spec, leaf in zip(specs, leaves):
        n = 1
        for dim, entry in zip(leaf.shape, tuple(spec) + (None,) * (len(leaf.shape) - len(spec))):
            names = () if entry is None else entry if isinstance(entry, tuple) else (entry,)
            prod = int(np.prod([sizes[a] for a in names] or [1]))
            assert dim % prod == 0
            n *= dim // prod
        total += n * np.dtype(leaf.dtype).itemsize
    return total


def _reference_argument_bytes(jcfg, shape, axes: tuple, sizes: dict, layout: str = "tp-fsdp") -> dict:
    """The reference dry run's arguments of a cell, per rank, by kind."""
    jm = jzoo.build_model(jcfg, jzoo.DistContext())
    p_sds = jax.eval_shape(lambda: jm.init(jax.random.PRNGKey(0), jnp.bfloat16))
    out = {"params": _spec_bytes(jspecs.param_pspecs(jcfg, p_sds, axes, sizes, layout=layout), p_sds, sizes)}
    batch = jax_input_specs(jcfg, shape)
    b_spec = jspecs.batch_pspecs(jcfg, shape, axes, **({"layout": layout} if shape.kind == "train" else {}))
    out["batch"] = sum(_spec_bytes(b_spec[k], v, sizes) for k, v in batch.items())
    if shape.kind == "train":
        opt = jax.eval_shape(jadamw_init, p_sds)
        out["opt_state"] = _spec_bytes(jspecs.opt_state_pspecs(jcfg, opt, axes, sizes, layout=layout), opt, sizes)
    if shape.kind == "decode":
        c_sds = jax.eval_shape(lambda: jzoo.init_cache(jcfg, shape.global_batch, shape.seq_len, jnp.bfloat16))
        out["cache"] = _spec_bytes(jspecs.cache_pspecs(jcfg, shape, c_sds, axes, sizes), c_sds, sizes)
    return out


def cut(shape):
    """A cell's shape cut for the CPU: sequence 32 and batch 8 at most (the
    batch of ``long_500k`` stays 1)."""
    return replace(shape, seq_len=min(shape.seq_len, 32), global_batch=min(shape.global_batch, 8))


def assert_bytes(res: dict, jcfg, shape, axes, sizes, layout="tp-fsdp") -> None:
    """A cell's argument bytes and analytic model against the reference's."""
    want = _reference_argument_bytes(jcfg, shape, axes, sizes, layout)
    assert res["memory"]["argument_bytes_by_kind"] == want, (res["arch"], shape.shape_id)
    assert res["memory"]["argument_bytes"] == sum(want.values())
    assert res["flops"]["model_cluster"] == jperf.model_flops(jcfg, shape)
    assert res["hbm_bytes_estimate"] == jperf.hbm_bytes_estimate(jcfg, shape)


def assert_traced_cell(res: dict, jcfg, shape, axes, sizes) -> None:
    """``assert_bytes``, and a trace that counted FLOPs and roofline terms."""
    assert_bytes(res, jcfg, shape, axes, sizes)
    assert res["flops"]["counted_cluster"] > 0 and set(res["roofline"]) >= {"compute_s", "memory_s", "dominant"}
