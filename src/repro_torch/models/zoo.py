"""Model zoo: parameters + prefill / loss / decode computations, on torch.

The PyTorch twin of the JAX package's ``models/zoo.py`` for the ``dense``
and ``vlm`` families (GQA attention, M-RoPE for qwen2-vl, (Sw)GLU / GELU /
ReLU² MLP). ``Model`` is an ``nn.Module`` that holds its parameters: the
reference's pytree becomes ``embed``, ``layers`` (one ``DenseLayer`` a
layer, its leading layer axis unstacked), ``final_ln`` and, when the
embeddings are not tied, ``head``; every weight keeps the reference's
(in, out) orientation (``x @ w``), so ``repro_torch.models.convert`` maps
the two one to one. The reference's ``lax.scan`` over stacked layers is a
Python loop over ``layers``.

The other families (``moe``, ``hybrid``, ``ssm``, ``audio``) raise
``NotImplementedError`` from ``build_model``: later slices of the port
bring them.
"""

from __future__ import annotations

from dataclasses import dataclass

import torch
from torch import nn

from ..configs.base import ArchConfig, get_config
from ..device import resolve_device
from .attention import chunked_attention, decode_attention
from .layers import apply_rope, mlp, mrope_freqs, norm, rope_freqs

__all__ = ["DistContext", "Model", "build_model"]

FAMILIES = ("dense", "vlm")
# the ROADMAP item of the port that brings each family not in this module
_LATER = {
    "moe": "the moe family (repro.models.moe)",
    "hybrid": "hybrid and ssm (repro.models.mamba2)",
    "ssm": "hybrid and ssm (repro.models.rwkv6)",
    "audio": "audio (the whisper encoder-decoder)",
}


# =============================================================================
# parameters
# =============================================================================


def _param(shape, dtype, device) -> nn.Parameter:
    # serving only: no autograd graph is built over the weights
    return nn.Parameter(torch.zeros(shape, dtype=dtype, device=device), requires_grad=False)


def _norm_params(cfg: ArchConfig, D: int, device) -> nn.ParameterDict | None:
    """Norm scale (and layernorm bias) stay f32 in any model dtype."""
    if cfg.nonparametric_ln:
        return None
    p = nn.ParameterDict({"scale": _param((D,), torch.float32, device)})
    if cfg.norm == "layernorm":
        p["bias"] = _param((D,), torch.float32, device)
    return p


def _attn_params(cfg: ArchConfig, dtype, device) -> nn.ParameterDict:
    D, H, Hkv, hd = cfg.d_model, cfg.n_heads, cfg.n_kv, cfg.hd
    p = nn.ParameterDict({
        "wq": _param((D, H * hd), dtype, device),
        "wk": _param((D, Hkv * hd), dtype, device),
        "wv": _param((D, Hkv * hd), dtype, device),
        "wo": _param((H * hd, D), dtype, device),
    })
    if cfg.qkv_bias:
        p["bq"] = _param((H * hd,), dtype, device)
        p["bk"] = _param((Hkv * hd,), dtype, device)
        p["bv"] = _param((Hkv * hd,), dtype, device)
    return p


def _mlp_params(cfg: ArchConfig, dtype, device) -> nn.ParameterDict:
    D, F = cfg.d_model, cfg.d_ff
    shapes = {"w_up": (D, F), "w_down": (F, D)}
    if cfg.activation == "swiglu":
        shapes = {"w_gate": (D, F), **shapes}
    return nn.ParameterDict({k: _param(s, dtype, device) for k, s in shapes.items()})


class DenseLayer(nn.Module):
    """One pre-norm block: ``x + attn(ln1(x))``, then ``x + mlp(ln2(x))``."""

    def __init__(self, cfg: ArchConfig, dtype, device):
        super().__init__()
        self.ln1 = _norm_params(cfg, cfg.d_model, device)
        self.attn = _attn_params(cfg, dtype, device)
        self.ln2 = _norm_params(cfg, cfg.d_model, device)
        self.mlp = _mlp_params(cfg, dtype, device)


# =============================================================================
# layer bodies
# =============================================================================


def _qkv(cfg: ArchConfig, x: torch.Tensor, p, name: str) -> torch.Tensor:
    y = x @ p[f"w{name}"]
    return y + p[f"b{name}"] if cfg.qkv_bias else y


def _attention_block(cfg: ArchConfig, x, p, cos, sin, dist: "DistContext", *, causal: bool = True):
    B, S, D = x.shape
    H, Hkv, hd = cfg.n_heads, cfg.n_kv, cfg.hd
    kv_dims = "b.m." if (dist.model_size > 1 and Hkv % dist.model_size == 0) else "b..."
    q = dist.wsc(_qkv(cfg, x, p, "q").reshape(B, S, H, hd), "b.m.")
    k = dist.wsc(_qkv(cfg, x, p, "k").reshape(B, S, Hkv, hd), kv_dims)
    v = dist.wsc(_qkv(cfg, x, p, "v").reshape(B, S, Hkv, hd), kv_dims)
    q, k = apply_rope(q, cos, sin), apply_rope(k, cos, sin)
    out = chunked_attention(q, k, v, causal=causal, window=cfg.sliding_window)
    out = dist.wsc(out, "b.m.")
    return out.reshape(B, S, H * hd) @ p["wo"]


def _dense_layer(cfg: ArchConfig, x, layer: DenseLayer, cos, sin, dist):
    h = norm(x, layer.ln1, cfg.norm)
    x = x + _attention_block(cfg, h, layer.attn, cos, sin, dist)
    h = norm(x, layer.ln2, cfg.norm)
    return x + mlp(h, layer.mlp, cfg.activation)


# =============================================================================
# full-sequence forward (prefill / loss)
# =============================================================================


@dataclass(frozen=True)
class DistContext:
    """Static distribution facts the model math needs: token-group counts for
    MoE dispatch, and the mesh axis names for explicit sharding constraints.

    The fields are the reference's. ``remat`` has no effect here: this slice
    builds no autograd graph, so there is nothing to rematerialize. ``wsc``
    is the identity when no axis is configured (one device); a context with
    axes raises ``NotImplementedError`` until the port's sharding slice.
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
        '.' (unsharded) per tensor dimension, e.g. "b.m." for (B,S,H,d)."""
        if not self.active:
            return x
        raise NotImplementedError(
            "sharding constraints need the port's sharding slice (repro.sharding.specs)"
        )


def _positions_and_rope(cfg: ArchConfig, batch: dict, S: int, B: int, device):
    if cfg.m_rope:
        pos = batch.get("positions")
        if pos is None:
            p1 = torch.arange(S, device=device)[None].expand(B, S)
            pos = torch.stack([p1, p1, p1], dim=1)
        return mrope_freqs(pos, cfg.hd, cfg.rope_theta, cfg.m_rope_sections)
    pos = torch.arange(S, device=device)[None].expand(B, S)
    return rope_freqs(pos, cfg.hd, cfg.rope_theta)


def _embed(cfg: ArchConfig, model: "Model", batch: dict) -> torch.Tensor:
    x = model.embed[batch["tokens"]]
    if cfg.frontend == "vision-stub" and "frontend_embeds" in batch:
        x = x + batch["frontend_embeds"].to(x.dtype)
    return x


def forward_hidden(model: "Model", batch: dict) -> tuple[torch.Tensor, torch.Tensor]:
    """Returns (final hidden states (B,S,D), aux loss scalar)."""
    cfg = model.cfg
    x = _embed(cfg, model, batch)
    B, S, D = x.shape
    cos, sin = _positions_and_rope(cfg, batch, S, B, x.device)
    for layer in model.layers:
        x = _dense_layer(cfg, x, layer, cos, sin, model.dist)
    x = norm(x, model.final_ln, cfg.norm)
    return x, torch.zeros((), dtype=torch.float32, device=x.device)


def logits_from_hidden(model: "Model", h: torch.Tensor) -> torch.Tensor:
    if model.cfg.tie_embeddings:
        return h @ model.embed.T
    return h @ model.head


def loss_fn(model: "Model", batch: dict, *, logit_chunk: int = 512) -> tuple[torch.Tensor, dict]:
    """Chunked softmax cross-entropy (never materializes (B,S,V) at once);
    forward only."""
    h, aux = forward_hidden(model, batch)
    B, S, D = h.shape
    labels = batch["labels"]
    C = min(logit_chunk, S)
    pad = -S % C
    if pad:
        h = torch.nn.functional.pad(h, (0, 0, 0, pad))
        labels = torch.nn.functional.pad(labels, (0, pad), value=-1)
    total = torch.zeros((), dtype=torch.float32, device=h.device)
    count = torch.zeros((), dtype=torch.float32, device=h.device)
    for c in range(0, S + pad, C):
        lch = labels[:, c : c + C]
        logits = logits_from_hidden(model, h[:, c : c + C]).float()
        lse = torch.logsumexp(logits, dim=-1)
        tgt = torch.gather(logits, -1, lch.clamp(min=0)[..., None].long())[..., 0]
        valid = (lch >= 0).float()
        total = total + ((lse - tgt) * valid).sum()
        count = count + valid.sum()
    ce = total / torch.clamp(count, min=1.0)
    loss = ce + 0.01 * aux
    return loss, {"ce": ce, "aux": aux, "tokens": count}


# =============================================================================
# decode (serve_step)
# =============================================================================


def init_cache(model: "Model", batch: int, cache_len: int, dtype=torch.float32) -> dict:
    """KV caches sized for ``cache_len`` history, on the model's device.
    ``pos`` starts at ``cache_len``: the first step writes slot 0 at rope
    position ``cache_len`` and attends every slot, the zero ones included."""
    cfg = model.cfg
    L, Hkv, hd = cfg.n_layers, cfg.n_kv, cfg.hd
    if cfg.sliding_window is not None:
        cache_len = min(cache_len, cfg.sliding_window)
    dev = model.embed.device
    return {
        "k": torch.zeros((L, batch, cache_len, Hkv, hd), dtype=dtype, device=dev),
        "v": torch.zeros((L, batch, cache_len, Hkv, hd), dtype=dtype, device=dev),
        "pos": torch.full((), cache_len, dtype=torch.int32, device=dev),
    }


def _decode_attn(cfg: ArchConfig, x, p, kc, vc, cos, sin, fill, slot, dist: "DistContext"):
    """One-token attention against a ring-buffer cache: the new KV pair is
    written in place to slot ``pos mod T`` of this layer's cache view (one
    ``index_copy_`` with a device index: no host sync), then the token
    attends the whole cache with age masking (warm-up via ``fill``, SWA via
    the window)."""
    B, _, D = x.shape
    H, Hkv, hd = cfg.n_heads, cfg.n_kv, cfg.hd
    q = apply_rope(_qkv(cfg, x, p, "q").reshape(B, 1, H, hd), cos, sin)
    k = apply_rope(_qkv(cfg, x, p, "k").reshape(B, 1, Hkv, hd), cos, sin)
    v = _qkv(cfg, x, p, "v").reshape(B, 1, Hkv, hd)
    if dist.decode_seq_shard:
        q = dist.wsc(q, "b...")
        kc = dist.wsc(kc, "bm..")
        vc = dist.wsc(vc, "bm..")
    index = slot.reshape(1).long()
    kc.index_copy_(1, index, k.to(kc.dtype))
    vc.index_copy_(1, index, v.to(vc.dtype))
    out = decode_attention(q, kc, vc, window=cfg.sliding_window, fill=fill, slot=slot)
    return out.reshape(B, 1, H * hd) @ p["wo"]


def decode_step(model: "Model", token: torch.Tensor, cache: dict, batch_extras: dict | None = None):
    """serve_step: one new token (B, 1) against the cache; returns (logits,
    cache). The cache's ``k``/``v`` are written in place (the step consumes
    its input cache, as the reference's donated buffers); the returned dict
    holds the same tensors and ``pos + 1``."""
    cfg, dist = model.cfg, model.dist
    batch = {"tokens": token, **(batch_extras or {})}
    x = _embed(cfg, model, batch)
    B = x.shape[0]
    pos = cache["pos"]
    if cfg.m_rope:
        cos, sin = mrope_freqs(pos.expand(B, 3, 1), cfg.hd, cfg.rope_theta, cfg.m_rope_sections)
    else:
        cos, sin = rope_freqs(pos.expand(B, 1), cfg.hd, cfg.rope_theta)

    fill = torch.clamp(pos + 1, max=2**30)
    slot = pos % cache["k"].shape[2]
    for i, layer in enumerate(model.layers):
        h = norm(x, layer.ln1, cfg.norm)
        x = x + _decode_attn(cfg, h, layer.attn, cache["k"][i], cache["v"][i], cos, sin, fill, slot, dist)
        h = norm(x, layer.ln2, cfg.norm)
        x = x + mlp(h, layer.mlp, cfg.activation)

    x = norm(x, model.final_ln, cfg.norm)
    return logits_from_hidden(model, x), {**cache, "pos": pos + 1}


# =============================================================================
# public bundle
# =============================================================================


class Model(nn.Module):
    """A dense / vlm language model and its parameters on one device.

    Methods mirror the reference's bundle with the parameters held by the
    module: ``hidden(batch)``, ``logits(batch)``, ``loss(batch)``,
    ``init_cache(batch, cache_len, dtype)`` and ``decode(token, cache,
    batch_extras)``. A batch is a dict of tensors on the model's device
    (``tokens`` (B, S) integer; ``labels``, ``positions`` (B, 3, S) and
    ``frontend_embeds`` where the reference takes them)."""

    def __init__(self, cfg: ArchConfig, dist: DistContext, *, device, dtype=torch.float32):
        super().__init__()
        if cfg.family not in FAMILIES:
            later = _LATER.get(cfg.family, "no slice")
            raise NotImplementedError(
                f"family {cfg.family!r} ({cfg.arch_id}) is not ported yet: ROADMAP Queue 1, {later}"
            )
        self.cfg, self.dist = cfg, dist
        D, V = cfg.d_model, cfg.vocab
        self.embed = _param((V, D), dtype, device)
        self.layers = nn.ModuleList(DenseLayer(cfg, dtype, device) for _ in range(cfg.n_layers))
        self.final_ln = _norm_params(cfg, D, device)
        if not cfg.tie_embeddings:
            self.head = _param((D, V), dtype, device)

    def init(self, generator: torch.Generator) -> "Model":
        """Draw the reference's initialization: embeddings N(0, 0.02²), every
        weight matrix N(0, 1/fan_in), QKV biases zero in the model dtype,
        norm scales one and biases zero in f32. Draws are f32 on the
        generator's device, in the order embed, head, then layer by layer
        (wq, wk, wv, wo, then the MLP's), and copied to the model's device:
        one seed gives the same weights on any device, and a model cut to
        fewer layers gets the first layers of the deeper one."""

        def draw(shape, std):
            return torch.randn(shape, generator=generator, device=generator.device, dtype=torch.float32) * std

        self.embed.copy_(draw(self.embed.shape, 0.02))
        if not self.cfg.tie_embeddings:
            self.head.copy_(draw(self.head.shape, self.cfg.d_model**-0.5))
        for layer in self.layers:
            for p in (layer.attn, layer.mlp):
                for name, w in p.items():
                    if name.startswith("w"):
                        w.copy_(draw(w.shape, w.shape[0] ** -0.5))
                    else:
                        w.zero_()
            for ln in (layer.ln1, layer.ln2):
                self._reset_norm(ln)
        self._reset_norm(self.final_ln)
        return self

    @staticmethod
    def _reset_norm(p) -> None:
        if p is not None:
            p["scale"].fill_(1.0)
            if "bias" in p:
                p["bias"].zero_()

    def hidden(self, batch: dict):
        return forward_hidden(self, batch)

    def logits(self, batch: dict) -> torch.Tensor:
        h, _ = forward_hidden(self, batch)
        return logits_from_hidden(self, h)

    def loss(self, batch: dict):
        return loss_fn(self, batch)

    def init_cache(self, batch: int, cache_len: int, dtype=torch.float32) -> dict:
        return init_cache(self, batch, cache_len, dtype)

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
