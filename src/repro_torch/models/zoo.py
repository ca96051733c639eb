"""Model zoo: parameters + prefill / loss / decode computations, on torch.

The PyTorch twin of the JAX package's ``models/zoo.py``, for every family:

  dense / vlm        GQA attention (+ M-RoPE for qwen2-vl) + (Sw)GLU MLP
  moe                GQA attention + capacity-routed expert MLP
                     (``repro_torch.models.moe``)
  hybrid (zamba2)    Mamba2 backbone (``repro_torch.models.mamba2``) + one
                     *shared* attention block applied after every
                     ``hybrid_attn_every`` layers, with its own KV cache per
                     application site
  ssm (rwkv6)        time-mix (WKV, data-dependent decay) + channel-mix
                     (``repro_torch.models.rwkv6``)
  audio (whisper)    encoder-decoder; the conv frontend is the reference's
                     stub, precomputed frame embeddings (``enc_embeds``)

``Model`` is an ``nn.Module`` that holds its parameters: the reference's
pytree becomes ``embed``, ``head`` (untied embeddings), ``layers`` (one
module a layer, the reference's leading layer axis unstacked), ``cross``
(whisper's decoder cross attention, one a layer), ``final_ln``, and the
families' own ``shared_attn`` (hybrid), ``ln0`` (ssm), ``encoder`` and
``enc_final_ln`` (audio). Every weight keeps the reference's (in, out)
orientation (``x @ w``), so ``repro_torch.models.convert`` maps the two one
to one. The reference's ``lax.scan`` over stacked layers is a Python loop.

Where the reference keeps a parameter or a computation in f32 (norms, the
router, the recurrent states), the port uses ``acc_dtype(dtype)``: f32 for
bf16 and f32 models, as there, and f64 for a float64 model.
"""

from __future__ import annotations

from dataclasses import dataclass

import torch
from torch import nn
from torch.distributed.tensor import DTensor
from torch.utils.checkpoint import checkpoint

from ..configs.base import ArchConfig, get_config
from ..device import resolve_device
from ..launch.mesh import current_mesh, mesh_axis_sizes
from .attention import chunked_attention, decode_attention
from .layers import acc_dtype, apply_rope, mlp, mrope_freqs, norm, reshape_heads, rope_freqs
from .mamba2 import mamba2_decode_step, mamba2_forward, mamba2_init_cache
from .moe import moe_layer
from .rwkv6 import rwkv6_channel_mix, rwkv6_channel_mix_step, rwkv6_init_cache, rwkv6_time_mix, rwkv6_time_mix_step

__all__ = ["DistContext", "Model", "build_model"]

FAMILIES = ("dense", "vlm", "moe", "ssm", "hybrid", "audio")
# the rwkv time-mix decay's low-rank width (the reference's constant)
RWKV_LORA = 64


# =============================================================================
# parameters
# =============================================================================


def _param(shape, dtype, device, init: tuple = ("fill", 0.0)) -> nn.Parameter:
    """A zero parameter (one that takes gradients) that carries how
    ``Model.init`` draws it: ``("normal", std)`` or ``("fill", value)``."""
    p = nn.Parameter(torch.zeros(shape, dtype=dtype, device=device))
    p.init_rule = init
    return p


def _lin(shape, fan_in: int, dtype, device, mult: float = 1.0) -> nn.Parameter:
    """A weight drawn N(0, 1/fan_in) (times ``mult``), as the reference's ``_lin``."""
    return _param(shape, dtype, device, ("normal", fan_in**-0.5 * mult))


def _norm_params(cfg: ArchConfig, D: int, hi, device, *, always: bool = False) -> nn.ParameterDict | None:
    """Norm scale (and layernorm bias), f32 in a bf16 or f32 model. None for
    a non-parametric norm, unless ``always`` (a scale of ones then)."""
    if cfg.nonparametric_ln and not always:
        return None
    p = nn.ParameterDict({"scale": _param((D,), hi, device, ("fill", 1.0))})
    if cfg.norm == "layernorm" and not cfg.nonparametric_ln:
        p["bias"] = _param((D,), hi, device)
    return p


def _attn_params(cfg: ArchConfig, dtype, device) -> nn.ParameterDict:
    D, H, Hkv, hd = cfg.d_model, cfg.n_heads, cfg.n_kv, cfg.hd
    p = nn.ParameterDict({
        "wq": _lin((D, H * hd), D, dtype, device),
        "wk": _lin((D, Hkv * hd), D, dtype, device),
        "wv": _lin((D, Hkv * hd), D, dtype, device),
        "wo": _lin((H * hd, D), H * hd, dtype, device),
    })
    if cfg.qkv_bias:
        p["bq"] = _param((H * hd,), dtype, device)
        p["bk"] = _param((Hkv * hd,), dtype, device)
        p["bv"] = _param((Hkv * hd,), dtype, device)
    return p


def _mlp_params(cfg: ArchConfig, dtype, device) -> nn.ParameterDict:
    D, F = cfg.d_model, cfg.d_ff
    p = {"w_up": _lin((D, F), D, dtype, device), "w_down": _lin((F, D), F, dtype, device)}
    if cfg.activation == "swiglu":
        p = {"w_gate": _lin((D, F), D, dtype, device), **p}
    return nn.ParameterDict(p)


def _moe_params(cfg: ArchConfig, dtype, hi, device) -> nn.ParameterDict:
    D, F, E = cfg.d_model, cfg.d_ff, cfg.n_experts
    return nn.ParameterDict({
        "router": _lin((D, E), D, hi, device),
        "w_gate": _lin((E, D, F), D, dtype, device),
        "w_up": _lin((E, D, F), D, dtype, device),
        "w_down": _lin((E, F, D), F, dtype, device),
    })


def _mamba_params(cfg: ArchConfig, dtype, hi, device) -> nn.ParameterDict:
    D = cfg.d_model
    d_inner = cfg.ssm_expand * D
    N, P, K = cfg.ssm_state, cfg.ssm_head_dim, cfg.ssm_conv
    H = d_inner // P
    conv_dim = d_inner + 2 * N
    return nn.ParameterDict({
        "in_proj": _lin((D, 2 * d_inner + 2 * N + H), D, dtype, device),
        "conv_w": _lin((K, conv_dim), K, dtype, device),
        "conv_b": _param((conv_dim,), dtype, device),
        "dt_bias": _param((H,), hi, device),
        "A_log": _param((H,), hi, device),
        "D_skip": _param((H,), hi, device, ("fill", 1.0)),
        "norm_scale": _param((d_inner,), dtype, device, ("fill", 1.0)),
        "out_proj": _lin((d_inner, D), d_inner, dtype, device),
    })


def _rwkv_params(cfg: ArchConfig, dtype, hi, device) -> nn.ParameterDict:
    D, F = cfg.d_model, cfg.d_ff
    H, hd = D // cfg.rwkv_head_dim, cfg.rwkv_head_dim
    p = {
        "w_r": _lin((D, D), D, dtype, device),
        "w_k": _lin((D, D), D, dtype, device),
        "w_v": _lin((D, D), D, dtype, device),
        "w_g": _lin((D, D), D, dtype, device),
        "w_o": _lin((D, D), D, dtype, device),
        "w_lora_a": _lin((D, RWKV_LORA), D, dtype, device),
        "w_lora_b": _lin((RWKV_LORA, D), RWKV_LORA, dtype, device, mult=0.1),
        "w0": _param((D,), hi, device, ("fill", -0.6)),
        "u": _param((H, hd), hi, device),
        "ln_x_scale": _param((D,), hi, device, ("fill", 1.0)),
        "ln_x_bias": _param((D,), hi, device),
        "w_ck": _lin((D, F), D, dtype, device),
        "w_cv": _lin((F, D), F, dtype, device),
        "w_cr": _lin((D, D), D, dtype, device),
    }
    for name in ("r", "k", "v", "g", "w", "ck", "cr"):
        p[f"mu_{name}"] = _param((D,), hi, device, ("fill", 0.5))
    return nn.ParameterDict(p)


class DenseLayer(nn.Module):
    """One pre-norm block: ``x + attn(ln1(x))``, then ``x + mlp(ln2(x))``.
    Also the encoder layers of ``audio`` and the ``shared_attn`` block of
    ``hybrid`` (whose norms always have a scale)."""

    def __init__(self, cfg: ArchConfig, dtype, hi, device, *, always_norm: bool = False):
        super().__init__()
        self.ln1 = _norm_params(cfg, cfg.d_model, hi, device, always=always_norm)
        self.attn = _attn_params(cfg, dtype, device)
        self.ln2 = _norm_params(cfg, cfg.d_model, hi, device, always=always_norm)
        self.mlp = _mlp_params(cfg, dtype, device)


class MoELayer(nn.Module):
    """``x + attn(ln1(x))``, then ``x + moe(ln2(x))``. While ``routes`` is a
    list, every call of the layer appends the expert ids it chose (see
    ``moe_layer``)."""

    def __init__(self, cfg: ArchConfig, dtype, hi, device):
        super().__init__()
        self.routes: list | None = None
        self.ln1 = _norm_params(cfg, cfg.d_model, hi, device)
        self.attn = _attn_params(cfg, dtype, device)
        self.ln2 = _norm_params(cfg, cfg.d_model, hi, device)
        self.moe = _moe_params(cfg, dtype, hi, device)


class RWKVLayer(nn.Module):
    """``x + time_mix(ln1(x))``, then ``x + channel_mix(ln2(x))``, both
    mixes' parameters in ``tm``; layer norms whatever ``cfg.norm``."""

    def __init__(self, cfg: ArchConfig, dtype, hi, device):
        super().__init__()
        self.tm = _rwkv_params(cfg, dtype, hi, device)
        self.ln1 = _norm_params(cfg, cfg.d_model, hi, device)
        self.ln2 = _norm_params(cfg, cfg.d_model, hi, device)


class MambaLayer(nn.Module):
    """``x + mamba2(ln1(x))``. ``ln2`` exists, as in the reference's tree,
    and is unused."""

    def __init__(self, cfg: ArchConfig, dtype, hi, device):
        super().__init__()
        self.mamba = _mamba_params(cfg, dtype, hi, device)
        self.ln1 = _norm_params(cfg, cfg.d_model, hi, device)
        self.ln2 = _norm_params(cfg, cfg.d_model, hi, device)


class CrossLayer(nn.Module):
    """Whisper's decoder cross attention of one layer: ``x + attn(ln(x))``
    with keys and values from the encoder's output."""

    def __init__(self, cfg: ArchConfig, dtype, hi, device):
        super().__init__()
        self.ln = _norm_params(cfg, cfg.d_model, hi, device)
        self.attn = _attn_params(cfg, dtype, device)


_LAYERS = {"dense": DenseLayer, "vlm": DenseLayer, "moe": MoELayer, "ssm": RWKVLayer, "hybrid": MambaLayer,
           "audio": DenseLayer}


# =============================================================================
# layer bodies
# =============================================================================


def _qkv(cfg: ArchConfig, x: torch.Tensor, p, name: str) -> torch.Tensor:
    y = x @ p[f"w{name}"]
    return y + p[f"b{name}"] if cfg.qkv_bias else y


def _attention_block(cfg: ArchConfig, x, p, cos, sin, dist: "DistContext", *, causal: bool = True,
                     kv_override: tuple[torch.Tensor, torch.Tensor] | None = None):
    """Self attention (rotary where ``cos`` is given), or attention over
    ``kv_override``'s keys and values (never causal, no rotation of them)."""
    B, S, D = x.shape
    H, Hkv, hd = cfg.n_heads, cfg.n_kv, cfg.hd
    kv_dims = "b.m." if (dist.model_size > 1 and Hkv % dist.model_size == 0) else "b..."
    q = dist.wsc(reshape_heads(_qkv(cfg, x, p, "q"), (B, S, H, hd)), "b.m.")
    if kv_override is None:
        k = dist.wsc(reshape_heads(_qkv(cfg, x, p, "k"), (B, S, Hkv, hd)), kv_dims)
        v = dist.wsc(reshape_heads(_qkv(cfg, x, p, "v"), (B, S, Hkv, hd)), kv_dims)
        if cos is not None:
            q, k = apply_rope(q, cos, sin), apply_rope(k, cos, sin)
    else:
        k, v = (dist.wsc(a, kv_dims) for a in kv_override)
        if cos is not None:
            q = apply_rope(q, cos, sin)
    out = chunked_attention(q, k, v, causal=causal and kv_override is None, window=cfg.sliding_window)
    out = dist.wsc(out, "b.m.")
    # the merged heads sharded on the model axis: where the heads could not
    # be (14 on 16), the backward pass then gathers the gradient before it
    # splits it into heads again
    return dist.wsc(out.reshape(B, S, H * hd), "b.m") @ p["wo"]


def _dense_layer(cfg: ArchConfig, x, layer: DenseLayer, cos, sin, dist):
    h = norm(x, layer.ln1, cfg.norm)
    x = x + _attention_block(cfg, h, layer.attn, cos, sin, dist)
    h = norm(x, layer.ln2, cfg.norm)
    return x + mlp(h, layer.mlp, cfg.activation)


def _moe(cfg: ArchConfig, h, layer: MoELayer, dist: "DistContext", n_token_groups: int):
    return moe_layer(
        h,
        layer.moe,
        n_experts=cfg.n_experts,
        top_k=cfg.top_k,
        capacity_factor=cfg.capacity_factor,
        n_token_groups=n_token_groups,
        expert_parallel=dist.model_size > 1 and cfg.n_experts % dist.model_size == 0,
        wsc=dist.wsc,
        routes=layer.routes,
    )


def _moe_dense_layer(cfg: ArchConfig, x, layer: MoELayer, cos, sin, dist):
    h = norm(x, layer.ln1, cfg.norm)
    x = x + _attention_block(cfg, h, layer.attn, cos, sin, dist)
    h = norm(x, layer.ln2, cfg.norm)
    y, aux = _moe(cfg, h, layer, dist, dist.n_token_groups)
    return x + y, aux


def _rwkv_layer(cfg: ArchConfig, x, layer: RWKVLayer, dist):
    h = norm(x, layer.ln1, "layernorm")
    x = x + rwkv6_time_mix(
        h, layer.tm, n_heads=cfg.d_model // cfg.rwkv_head_dim, head_dim=cfg.rwkv_head_dim, wsc=dist.wsc
    )
    h = norm(x, layer.ln2, "layernorm")
    return x + rwkv6_channel_mix(h, layer.tm)


def _mamba_layer(cfg: ArchConfig, x, layer: MambaLayer, dist):
    h = norm(x, layer.ln1, cfg.norm)
    return x + mamba2_forward(h, layer.mamba, d_state=cfg.ssm_state, head_dim=cfg.ssm_head_dim, wsc=dist.wsc)


# =============================================================================
# full-sequence forward (prefill / loss)
# =============================================================================


@dataclass(frozen=True)
class DistContext:
    """Static distribution facts the model math needs: token-group counts for
    MoE dispatch, and the mesh axis names for explicit sharding constraints.

    The fields are the reference's. ``remat`` recomputes each layer body in
    the backward pass instead of keeping its activations, at the reference's
    granularity (``_remat``); it applies only where grad mode is on, so
    prefill and decode never pay for it. ``wsc`` is the identity when no
    axis is configured (one device). A context with axes is active: the
    parameters and inputs are DTensors placed by
    ``repro_torch.sharding.specs``, the model runs inside
    ``repro_torch.launch.mesh.mesh_scope``, and ``wsc`` redistributes each
    constrained tensor on that mesh.
    """

    n_token_groups: int = 1
    remat: bool = True
    batch_axes: tuple[str, ...] = ()
    model_axis: str | None = None
    model_size: int = 1
    # decode KV caches sequence-sharded on the model axis (serving layout
    # for archs whose kv-head count does not divide the axis)
    decode_seq_shard: bool = False

    @property
    def active(self) -> bool:
        return bool(self.batch_axes) or self.model_axis is not None

    def wsc(self, x: torch.Tensor, dims: str) -> torch.Tensor:
        """Constrain: dims is a string of 'b' (batch axes), 'm' (model axis),
        '.' (unsharded) per tensor dimension, e.g. "b.m." for (B,S,H,d).
        Under an active context ``x`` must be a DTensor, and the model runs
        inside ``repro_torch.launch.mesh.mesh_scope(mesh)`` (the reference's
        ``with mesh:``): ``x`` is redistributed on that mesh to those
        placements. An axis whose size does not divide its dimension is
        left out (replicated), as ``_sanitize`` leaves it out of an explicit
        sharding."""
        if not self.active:
            return x
        from ..sharding.specs import _sanitize, to_placements  # imports this module (through convert)

        mesh = current_mesh()
        if mesh is None or not isinstance(x, DTensor):
            raise NotImplementedError("an active DistContext constrains DTensors inside "
                                      "repro_torch.launch.mesh.mesh_scope: place the parameters and inputs on "
                                      "its mesh (repro_torch.sharding.specs)")
        batch = self.batch_axes if len(self.batch_axes) != 1 else self.batch_axes[0]
        spec = tuple({"b": batch or None, "m": self.model_axis}.get(d) for d in dims)
        return x.redistribute(mesh, to_placements(_sanitize(spec, tuple(x.shape), mesh_axis_sizes(mesh)), mesh))


def _remat(dist: DistContext, fn, *args):
    """``fn(*args)``; where ``dist.remat`` and grad mode is on, its
    activations are recomputed in the backward pass instead of kept (a
    non-reentrant ``torch.utils.checkpoint``), as the reference's
    ``jax.checkpoint`` of a layer body."""
    if dist.remat and torch.is_grad_enabled():
        return checkpoint(fn, *args, use_reentrant=False)
    return fn(*args)


def _positions_and_rope(cfg: ArchConfig, batch: dict, S: int, B: int, device, dtype):
    if cfg.is_encoder_decoder:
        return None, None  # whisper: its positions are in the stubbed embeddings
    if cfg.m_rope:
        pos = batch.get("positions")
        if pos is None:
            p1 = torch.arange(S, device=device)[None].expand(B, S)
            pos = torch.stack([p1, p1, p1], dim=1)
        return mrope_freqs(pos, cfg.hd, cfg.rope_theta, cfg.m_rope_sections, dtype)
    pos = torch.arange(S, device=device)[None].expand(B, S)
    return rope_freqs(pos, cfg.hd, cfg.rope_theta, dtype)


def _embed(cfg: ArchConfig, model: "Model", batch: dict) -> torch.Tensor:
    x = model.embed[batch["tokens"]]
    if cfg.frontend == "vision-stub" and "frontend_embeds" in batch:
        x = x + batch["frontend_embeds"].to(x.dtype)
    if cfg.family == "ssm":
        x = norm(x, model.ln0, "layernorm")
    return x


def _encoder_layer(cfg: ArchConfig, x, layer: DenseLayer, dist):
    h = norm(x, layer.ln1, cfg.norm)
    x = x + _attention_block(cfg, h, layer.attn, None, None, dist, causal=False)
    h = norm(x, layer.ln2, cfg.norm)
    return x + mlp(h, layer.mlp, cfg.activation)


def encoder_forward(model: "Model", enc_embeds: torch.Tensor) -> torch.Tensor:
    """Whisper's non-causal encoder over the frame embeddings (B, Tenc, D),
    then ``enc_final_ln``."""
    cfg = model.cfg
    x = enc_embeds.to(model.embed.dtype)
    for layer in model.encoder:
        x = _remat(model.dist, _encoder_layer, cfg, x, layer, model.dist)
    return norm(x, model.enc_final_ln, cfg.norm)


def _cross_kv(cfg: ArchConfig, enc: torch.Tensor, cross: CrossLayer):
    B = enc.shape[0]
    T = enc.shape[1]
    ek = reshape_heads(enc @ cross.attn["wk"], (B, T, cfg.n_kv, cfg.hd))
    ev = reshape_heads(enc @ cross.attn["wv"], (B, T, cfg.n_kv, cfg.hd))
    return ek, ev


def _audio_layer(cfg: ArchConfig, x, layer: DenseLayer, cross: CrossLayer, enc, dist):
    h = norm(x, layer.ln1, cfg.norm)
    x = x + _attention_block(cfg, h, layer.attn, None, None, dist, causal=True)
    hq = norm(x, cross.ln, cfg.norm)
    x = x + _attention_block(cfg, hq, cross.attn, None, None, dist, causal=False,
                             kv_override=_cross_kv(cfg, enc, cross))
    h = norm(x, layer.ln2, cfg.norm)
    return x + mlp(h, layer.mlp, cfg.activation)


def forward_hidden(model: "Model", batch: dict) -> tuple[torch.Tensor, torch.Tensor]:
    """Returns (final hidden states (B,S,D), aux loss scalar). Under
    ``dist.remat`` each layer body is rematerialized (``_remat``): every
    layer, whisper's encoder and decoder layers, and each of the hybrid's
    shared-attention sites."""
    cfg, dist = model.cfg, model.dist
    x = _embed(cfg, model, batch)
    B, S, D = x.shape
    acc = acc_dtype(x.dtype)
    cos, sin = _positions_and_rope(cfg, batch, S, B, x.device, acc)
    aux = torch.zeros((), dtype=acc, device=x.device)
    if cfg.family in ("dense", "vlm"):
        for layer in model.layers:
            x = _remat(dist, _dense_layer, cfg, x, layer, cos, sin, dist)
    elif cfg.family == "moe":
        for layer in model.layers:
            x, a = _remat(dist, _moe_dense_layer, cfg, x, layer, cos, sin, dist)
            aux = aux + a
    elif cfg.family == "ssm":
        for layer in model.layers:
            x = _remat(dist, _rwkv_layer, cfg, x, layer, dist)
    elif cfg.family == "hybrid":
        every = cfg.hybrid_attn_every
        for gi in range(cfg.n_layers // every):
            for layer in model.layers[gi * every : (gi + 1) * every]:
                x = _remat(dist, _mamba_layer, cfg, x, layer, dist)
            x = _remat(dist, _dense_layer, cfg, x, model.shared_attn, cos, sin, dist)  # the one shared block
    elif cfg.family == "audio":
        enc = encoder_forward(model, batch["enc_embeds"].to(x.dtype))
        for layer, cross in zip(model.layers, model.cross):
            x = _remat(dist, _audio_layer, cfg, x, layer, cross, enc, dist)
    else:
        raise ValueError(cfg.family)
    x = norm(x, model.final_ln, cfg.norm)
    return x, aux


def logits_from_hidden(model: "Model", h: torch.Tensor) -> torch.Tensor:
    if model.cfg.tie_embeddings:
        return h @ model.embed.T
    return h @ model.head


def _chunk_nll(model: "Model", hch: torch.Tensor, lch: torch.Tensor, acc: torch.dtype):
    """One chunk's summed negative log-likelihood over its valid labels
    (``>= 0``), and their count."""
    # vocab replicated: DTensor's gather of a vocab-sharded tensor leaves a
    # masked partial that its later reduction cannot take
    logits = model.dist.wsc(logits_from_hidden(model, hch).to(acc), "b..")
    lse = torch.logsumexp(logits, dim=-1)
    tgt = torch.gather(logits, -1, lch.clamp(min=0)[..., None].long())[..., 0]
    valid = (lch >= 0).to(acc)
    return ((lse - tgt) * valid).sum(), valid.sum()


def loss_fn(model: "Model", batch: dict, *, logit_chunk: int = 512) -> tuple[torch.Tensor, dict]:
    """Chunked softmax cross-entropy (never materializes (B,S,V) at once).
    Under ``dist.remat`` each chunk's logits are recomputed in the backward
    pass too: kept, every chunk's (B, C, V) f32 logits would stay alive for
    it, B*S*V*4 bytes in all."""
    h, aux = forward_hidden(model, batch)
    B, S, D = h.shape
    acc = acc_dtype(h.dtype)
    labels = batch["labels"]
    C = min(logit_chunk, S)
    pad = -S % C
    if pad:
        h = torch.nn.functional.pad(h, (0, 0, 0, pad))
        labels = torch.nn.functional.pad(labels, (0, pad), value=-1)
    total = torch.zeros((), dtype=acc, device=h.device)
    count = torch.zeros((), dtype=acc, device=h.device)
    for c in range(0, S + pad, C):
        nll, n = _remat(model.dist, _chunk_nll, model, h[:, c : c + C], labels[:, c : c + C], acc)
        total = total + nll
        count = count + n
    ce = total / torch.clamp(count, min=1.0)
    loss = ce + 0.01 * aux
    return loss, {"ce": ce, "aux": aux, "tokens": count}


# =============================================================================
# decode (serve_step)
# =============================================================================


def init_cache(model: "Model", batch: int, cache_len: int, dtype=torch.float32) -> dict:
    """KV caches (in ``dtype``) and recurrent states (f32; f64 for an f64
    model) sized for ``cache_len`` history, on the model's device. ``pos``
    starts at ``cache_len``: the first step writes slot 0 at rope position
    ``cache_len`` and attends every slot, the zero ones included. ``ssm``
    carries states only (no ``pos``); ``audio``'s ``ek``/``ev`` hold the
    cross-attention keys and values of ``encoder_len`` frames, zero until
    ``Model.fill_cross_cache`` writes them."""
    cfg = model.cfg
    L, Hkv, hd, D = cfg.n_layers, cfg.n_kv, cfg.hd, cfg.d_model
    if cfg.sliding_window is not None:
        cache_len = min(cache_len, cfg.sliding_window)
    dev = model.embed.device
    hi = acc_dtype(model.embed.dtype)

    def kv(n: int, T: int) -> torch.Tensor:
        return torch.zeros((n, batch, T, Hkv, hd), dtype=dtype, device=dev)

    def stacked(one: dict) -> dict:
        return {k: torch.zeros((L, *v.shape), dtype=v.dtype, device=dev) for k, v in one.items()}

    pos = torch.full((), cache_len, dtype=torch.int32, device=dev)
    if cfg.family in ("dense", "vlm", "moe"):
        return {"k": kv(L, cache_len), "v": kv(L, cache_len), "pos": pos}
    if cfg.family == "ssm":
        return stacked(rwkv6_init_cache(batch, D, D // cfg.rwkv_head_dim, cfg.rwkv_head_dim, dtype=hi, device=dev))
    if cfg.family == "hybrid":
        mamba = mamba2_init_cache(batch, model.layers[0].mamba, d_state=cfg.ssm_state, head_dim=cfg.ssm_head_dim,
                                  conv_k=cfg.ssm_conv, dtype=hi)
        sites = cfg.n_layers // cfg.hybrid_attn_every
        return {"mamba": stacked(mamba), "k": kv(sites, cache_len), "v": kv(sites, cache_len), "pos": pos}
    if cfg.family == "audio":
        return {"k": kv(L, cache_len), "v": kv(L, cache_len), "ek": kv(L, cfg.encoder_len),
                "ev": kv(L, cfg.encoder_len), "pos": pos}
    raise ValueError(cfg.family)


def fill_cross_cache(model: "Model", cache: dict, enc_embeds: torch.Tensor) -> dict:
    """Write ``audio``'s ``ek``/``ev`` in place: each decoder layer's cross
    keys and values of the encoder's output over ``enc_embeds`` (B, Tenc, D),
    the same products ``Model.logits`` forms for its cross attention."""
    enc = encoder_forward(model, enc_embeds)
    for i, cross in enumerate(model.cross):
        ek, ev = _cross_kv(model.cfg, enc, cross)
        cache["ek"][i].copy_(ek)
        cache["ev"][i].copy_(ev)
    return cache


def _write_slot(cache: torch.Tensor, new: torch.Tensor, slot: torch.Tensor, dist: "DistContext") -> None:
    """Write ``new`` (B, 1, Hkv, d) into slot ``slot`` of ``cache`` (B, T,
    Hkv, d) in place. Under an active context the write selects over the
    whole cache: DTensor's ``index_copy_`` cannot write a sharded cache in
    place (it leaves the shard's placement wrong)."""
    if dist.active:
        hit = torch.arange(cache.shape[1], device=slot.device) == slot
        cache.copy_(torch.where(hit[None, :, None, None], new.to(cache.dtype), cache))
    else:
        cache.index_copy_(1, slot.reshape(1).long(), new.to(cache.dtype))


def _decode_attn(cfg: ArchConfig, x, p, kc, vc, cos, sin, fill, slot, dist: "DistContext"):
    """One-token attention against a ring-buffer cache: the new KV pair is
    written in place to slot ``pos mod T`` of this layer's cache view (one
    ``index_copy_`` with a device index: no host sync), then the token
    attends the whole cache with age masking (warm-up via ``fill``, SWA via
    the window). No rotation where ``cos`` is None."""
    B, _, D = x.shape
    H, Hkv, hd = cfg.n_heads, cfg.n_kv, cfg.hd
    q = reshape_heads(_qkv(cfg, x, p, "q"), (B, 1, H, hd))
    k = reshape_heads(_qkv(cfg, x, p, "k"), (B, 1, Hkv, hd))
    v = reshape_heads(_qkv(cfg, x, p, "v"), (B, 1, Hkv, hd))
    if cos is not None:
        q, k = apply_rope(q, cos, sin), apply_rope(k, cos, sin)
    _write_slot(kc, k, slot, dist)
    _write_slot(vc, v, slot, dist)
    if dist.decode_seq_shard:
        q = dist.wsc(q, "b...")
        kc = dist.wsc(kc, "bm..")
        vc = dist.wsc(vc, "bm..")
    out = decode_attention(q, kc, vc, window=cfg.sliding_window, fill=fill, slot=slot)
    return out.reshape(B, 1, H * hd) @ p["wo"]


def decode_step(model: "Model", token: torch.Tensor, cache: dict, batch_extras: dict | None = None):
    """serve_step: one new token (B, 1) against the cache; returns (logits,
    cache). The cache's tensors (k/v, recurrent states) are written in place
    (the step consumes its input cache, as the reference's donated buffers);
    the returned dict holds the same tensors and, where there is one,
    ``pos + 1``."""
    cfg, dist = model.cfg, model.dist
    batch = {"tokens": token, **(batch_extras or {})}
    x = _embed(cfg, model, batch)
    B = x.shape[0]
    acc = acc_dtype(x.dtype)
    pos = cache.get("pos")
    if cfg.is_encoder_decoder or cfg.family == "ssm":
        cos = sin = None
    elif cfg.m_rope:
        cos, sin = mrope_freqs(pos.expand(B, 3, 1), cfg.hd, cfg.rope_theta, cfg.m_rope_sections, acc)
    else:
        cos, sin = rope_freqs(pos.expand(B, 1), cfg.hd, cfg.rope_theta, acc)
    fill = slot = None
    if pos is not None:
        fill = torch.clamp(pos + 1, max=2**30)
        slot = pos % cache["k"].shape[2]

    if cfg.family in ("dense", "vlm", "moe"):
        for i, layer in enumerate(model.layers):
            h = norm(x, layer.ln1, cfg.norm)
            x = x + _decode_attn(cfg, h, layer.attn, cache["k"][i], cache["v"][i], cos, sin, fill, slot, dist)
            h = norm(x, layer.ln2, cfg.norm)
            if cfg.family == "moe":
                x = x + _moe(cfg, h, layer, dist, 1)[0]
            else:
                x = x + mlp(h, layer.mlp, cfg.activation)

    elif cfg.family == "ssm":
        H, hd = cfg.d_model // cfg.rwkv_head_dim, cfg.rwkv_head_dim
        for i, layer in enumerate(model.layers):
            h = norm(x, layer.ln1, "layernorm")[:, 0]
            y, wkv = rwkv6_time_mix_step(h, cache["shift_t"][i], cache["wkv"][i], layer.tm, n_heads=H, head_dim=hd)
            x = x + y[:, None]
            h2 = norm(x, layer.ln2, "layernorm")[:, 0]
            x = x + rwkv6_channel_mix_step(h2, cache["shift_c"][i], layer.tm)[:, None]
            cache["shift_t"][i].copy_(h)
            cache["shift_c"][i].copy_(h2)
            cache["wkv"][i].copy_(wkv)

    elif cfg.family == "hybrid":
        every, state = cfg.hybrid_attn_every, cache["mamba"]
        sp = model.shared_attn
        for gi in range(cfg.n_layers // every):
            for i in range(gi * every, (gi + 1) * every):
                layer = model.layers[i]
                h = norm(x, layer.ln1, cfg.norm)
                y, new = mamba2_decode_step(h, {"conv": state["conv"][i], "ssm": state["ssm"][i]}, layer.mamba,
                                            d_state=cfg.ssm_state, head_dim=cfg.ssm_head_dim)
                x = x + y
                state["conv"][i].copy_(new["conv"])
                state["ssm"][i].copy_(new["ssm"])
            h = norm(x, sp.ln1, cfg.norm)
            x = x + _decode_attn(cfg, h, sp.attn, cache["k"][gi], cache["v"][gi], cos, sin, fill, slot, dist)
            h = norm(x, sp.ln2, cfg.norm)
            x = x + mlp(h, sp.mlp, cfg.activation)

    elif cfg.family == "audio":
        H, hd = cfg.n_heads, cfg.hd
        for i, (layer, cross) in enumerate(zip(model.layers, model.cross)):
            h = norm(x, layer.ln1, cfg.norm)
            x = x + _decode_attn(cfg, h, layer.attn, cache["k"][i], cache["v"][i], None, None, fill, slot, dist)
            hq = norm(x, cross.ln, cfg.norm)
            q = reshape_heads(hq @ cross.attn["wq"], (B, 1, H, hd))
            xatt = decode_attention(q, cache["ek"][i], cache["ev"][i])
            x = x + xatt.reshape(B, 1, H * hd) @ cross.attn["wo"]
            h = norm(x, layer.ln2, cfg.norm)
            x = x + mlp(h, layer.mlp, cfg.activation)
    else:
        raise ValueError(cfg.family)

    x = norm(x, model.final_ln, cfg.norm)
    new_cache = dict(cache)
    if pos is not None:
        new_cache["pos"] = pos + 1
    return logits_from_hidden(model, x), new_cache


# =============================================================================
# public bundle
# =============================================================================


class Model(nn.Module):
    """A language model of any family and its parameters on one device.

    Methods mirror the reference's bundle with the parameters held by the
    module: ``hidden(batch)``, ``logits(batch)``, ``loss(batch)``,
    ``init_cache(batch, cache_len, dtype)`` and ``decode(token, cache,
    batch_extras)``; ``audio`` adds ``fill_cross_cache(cache, enc_embeds)``.
    The parameters take gradients: ``loss(batch)`` is what
    ``repro_torch.train.make_train_step`` differentiates. ``decode`` and
    ``fill_cross_cache`` write a cache in place and build no autograd graph.
    A batch is a dict of tensors on the model's device (``tokens`` (B, S)
    integer; ``labels``, ``positions`` (B, 3, S), ``frontend_embeds`` and
    ``enc_embeds`` (B, encoder_len, D) where the reference takes them)."""

    def __init__(self, cfg: ArchConfig, dist: DistContext, *, device, dtype=torch.float32):
        super().__init__()
        if cfg.family not in FAMILIES:
            raise ValueError(f"unknown family {cfg.family!r} ({cfg.arch_id})")
        self.cfg, self.dist = cfg, dist
        D, V = cfg.d_model, cfg.vocab
        hi = acc_dtype(dtype)
        # registration order is the order Model.init draws in
        self.embed = _param((V, D), dtype, device, ("normal", 0.02))
        if not cfg.tie_embeddings:
            self.head = _lin((D, V), D, dtype, device)
        self.layers = nn.ModuleList(_LAYERS[cfg.family](cfg, dtype, hi, device) for _ in range(cfg.n_layers))
        self.final_ln = _norm_params(cfg, D, hi, device)
        if cfg.family == "hybrid":
            self.shared_attn = DenseLayer(cfg, dtype, hi, device, always_norm=True)
        if cfg.family == "ssm":
            self.ln0 = nn.ParameterDict({"scale": _param((D,), hi, device, ("fill", 1.0)),
                                         "bias": _param((D,), hi, device)})
        if cfg.is_encoder_decoder:
            self.encoder = nn.ModuleList(DenseLayer(cfg, dtype, hi, device) for _ in range(cfg.encoder_layers))
            self.enc_final_ln = _norm_params(cfg, D, hi, device)
            self.cross = nn.ModuleList(CrossLayer(cfg, dtype, hi, device) for _ in range(cfg.n_layers))

    def init(self, generator: torch.Generator) -> "Model":
        """Draw the reference's initialization: embeddings N(0, 0.02²), every
        weight matrix N(0, 1/fan_in) (rwkv's decay ``w_lora_b`` times 0.1),
        biases zero in the model dtype, norm scales one and biases zero in
        f32, and the reference's constants for the rwkv and mamba vectors.
        Draws are f32 on the generator's device, in the order of
        ``named_parameters`` (embed, head, layer by layer, then the
        families' extra blocks), and copied to the model's device: one seed
        gives the same weights on any device, and a model cut to fewer
        layers gets the first layers of the deeper one."""
        with torch.no_grad():
            for _, p in self.named_parameters():
                kind, arg = p.init_rule
                if kind == "normal":
                    w = torch.randn(p.shape, generator=generator, device=generator.device, dtype=torch.float32)
                    p.copy_(w * arg)
                else:
                    p.fill_(arg)
        return self

    def hidden(self, batch: dict):
        return forward_hidden(self, batch)

    def logits(self, batch: dict) -> torch.Tensor:
        h, _ = forward_hidden(self, batch)
        return logits_from_hidden(self, h)

    def loss(self, batch: dict):
        return loss_fn(self, batch)

    def init_cache(self, batch: int, cache_len: int, dtype=torch.float32) -> dict:
        return init_cache(self, batch, cache_len, dtype)

    @torch.no_grad()
    def fill_cross_cache(self, cache: dict, enc_embeds: torch.Tensor) -> dict:
        return fill_cross_cache(self, cache, enc_embeds)

    @torch.no_grad()
    def decode(self, token: torch.Tensor, cache: dict, batch_extras: dict | None = None):
        return decode_step(self, token, cache, batch_extras)


def build_model(
    cfg: ArchConfig | str,
    dist: DistContext | None = None,
    *,
    device: str | torch.device | None = None,
    dtype: torch.dtype = torch.float32,
    generator: torch.Generator | None = None,
) -> Model:
    """The model of ``cfg`` on ``device`` (the card unless the caller names
    another; ``None`` without a card raises). With ``generator`` the weights
    are drawn by ``Model.init``; without it they stay zero until ``init``
    or ``repro_torch.models.convert`` fills them."""
    if isinstance(cfg, str):
        cfg = get_config(cfg)
    model = Model(cfg, dist or DistContext(), device=resolve_device(device), dtype=dtype)
    return model.init(generator) if generator is not None else model
