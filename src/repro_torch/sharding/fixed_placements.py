"""Products, views and pointwise operations on a mesh, placed by one fixed
rule instead of DTensor's search.

A product (``aten.mm``, ``aten.bmm``) whose operand merges two sharded
dimensions into one (the batch and the heads of ``chunked_attention``'s
``(B*H, q, d)`` products, the batch and a sequence sharded on "model" in a
linear layer's ``(B*S, D)``) carries a ``_StridedShard`` where DTensor's
own view rule makes it. DTensor costs each candidate strategy of such a
product with a search over placement states: 1-6 s a signature on a 2-D
mesh, more than 20 s on a 3-D one (torch 2.13 on one CPU core). Torch
2.11's DTensor cannot make a strided shard at all: its view refuses to
flatten sharded heads, and 29 of the 33 reduced cells failed on a (2, 2)
mesh there (``PERF.md`` section 6).

``FixedPlacements`` is the dispatch mode that ``repro_torch.launch.mesh.
mesh_scope`` holds on every mesh. Mesh axis by mesh axis, from the
operands' placements:

* a product ``a @ b`` (``(b, m, k) @ (b, k, n)`` or ``(m, k) @ (k, n)``):
  where ``a`` shards its batch or its contraction, ``b`` takes the same
  shard of its own (the output sharded on the batch, or a partial sum);
  where ``a`` shards its rows or holds a partial sum, ``b`` is gathered;
  where ``a`` is replicated, ``b`` keeps its placement (its columns shard
  the output's; a shard of its batch or contraction is cut from ``a``, a
  local chunk). A partial output is reduced (all-reduce) before it leaves;
* a pointwise operation: its operands' partial sums are reduced, then the
  output takes the operands' shards, an operand replicated where the
  output is sharded is cut to that shard if it is full there, and one that
  broadcasts there stays replicated;
* a view (``view_placements``): merged dimensions keep their shards, an
  inner one as a strided shard, and a split hands them back (a shard the
  split cannot follow is gathered first); a transpose or a detach of a
  strided tensor renames its dimensions. Those strided shards live only
  between a view and the product it feeds, so DTensor never plans one
  (torch 2.11's DTensor cannot make them at all);
* the embedding's backward, an accumulating index put into a replicated
  table, adds each rank's own rows (a partial sum, reduced); an index or
  another index put whose index tensor splits one dimension on two axes
  keeps the first (torch 2.11's DTensor refuses two); a flip of unsplit
  dimensions is local, and a constant pad gathers its padded dimensions.

Operations the rule does not place go to DTensor. The rule plans each
signature once a process (``PLANS``), as DTensor plans its own.

A shard is moved only where DTensor moves it right: a dimension that holds
a strided shard is gathered or cut from a replicated axis, never re-split
(torch 2.13 gave a ``(S, S, _S(sf=2))`` tensor moved to ``(S, R, _S(sf=4))``
twice its shard); a product that would need that gathers the strided
shards of both operands first. Each rank computes the block its operand
blocks give it. The FLOPs counted above this mode (``step_analysis``) are
DTensor's global shapes, as before; the redistributions made here run
while that module's collective counter is suspended, and count themselves
into it (``counting_collectives``).
"""

from __future__ import annotations

import torch
from torch.distributed.tensor import DTensor, Partial, Replicate, Shard
from torch.distributed.tensor._dtensor_spec import DTensorSpec, TensorMeta
from torch.distributed.tensor.placement_types import _StridedShard
from torch.utils._python_dispatch import TorchDispatchMode

from ..launch.step_analysis import counting_collectives

__all__ = ["FixedPlacements", "product_placements", "pointwise_placements", "view_placements"]

aten = torch.ops.aten
# each product's dimension labels: a, b, out
_LABELS = {
    aten.mm.default: ("mk", "kn", "mn"),
    aten.bmm.default: ("bmk", "bkn", "bmn"),
}
_SHARDS = (Shard, _StridedShard)


def _shard_on(p, dim: int):
    """Shard ``p`` (a strided one keeps its factor) on dimension ``dim``."""
    return _StridedShard(dim, split_factor=p.split_factor) if isinstance(p, _StridedShard) else Shard(dim)


def _label(p, labels: str) -> str:
    if isinstance(p, _SHARDS):
        return labels[p.dim]
    return "P" if isinstance(p, Partial) else "R"


def _moved(p, src: str, dst: str):
    """Shard ``p`` of a dimension labelled in ``src`` moved to the dimension
    with the same label in ``dst``."""
    return _shard_on(p, dst.index(src[p.dim]))


def product_placements(op, pa: tuple, pb: tuple) -> tuple[list, list, list]:
    """The placements ``a`` and ``b`` take, and the output's, for a product
    ``op`` of operands placed ``pa`` and ``pb``."""
    la_, lb_, lo_ = _LABELS[op]
    ta, tb, to = [], [], []
    for x, y in zip(pa, pb):
        la, lb = _label(x, la_), _label(y, lb_)
        if la == "R":
            if lb in "bk":
                x = _moved(y, lb_, la_)
            out = _moved(y, lb_, lo_) if lb in "bn" else y if lb == "P" else Partial() if lb == "k" else Replicate()
        elif la in "mP":
            y = Replicate()
            out = _moved(x, la_, lo_) if la == "m" else x
        else:  # a shard of the batch or the contraction
            y = _moved(x, la_, lb_)
            out = _moved(x, la_, lo_) if la == "b" else Partial()
        ta.append(x)
        tb.append(y)
        to.append(out)
    return ta, tb, to


def pointwise_placements(shapes: list, placements: list) -> list | None:
    """The output's placements of a pointwise operation on operands of
    ``shapes`` (broadcast together) placed ``placements`` (a tuple an
    operand, no partial sum), or None where two operands shard the output
    differently on one mesh axis."""
    n = len(torch.broadcast_shapes(*shapes))
    out = []
    for per_axis in zip(*placements):
        q = Replicate()
        for shape, p in zip(shapes, per_axis):
            if isinstance(p, _SHARDS):
                mine = _shard_on(p, p.dim + n - len(shape))
                if q != Replicate() and q != mine:
                    return None
                q = mine
        out.append(q)
    return out


def _operand_placements(shape: tuple, out: list, n: int) -> list:
    """An operand's placements under output placements ``out`` (of ``n``
    dimensions): the output's shard where the operand is full in that
    dimension, replicated where it broadcasts."""
    tgt = []
    for q in out:
        d = q.dim - (n - len(shape)) if isinstance(q, _SHARDS) else -1
        tgt.append(_shard_on(q, d) if d >= 0 and shape[d] != 1 else Replicate())
    return tgt


def _moves_a_strided_dim(cur, tgt) -> bool:
    """Whether going from placements ``cur`` to ``tgt`` re-splits a tensor
    dimension that holds a strided shard: anything but gathering a strided
    shard, cutting one from a replicated axis, or cutting a dimension that
    no axis splits yet (local chunks, right on every rank)."""
    strided = {p.dim for p in (*cur, *tgt) if isinstance(p, _StridedShard)}
    split = {p.dim for p in cur if isinstance(p, _SHARDS)}

    def allowed(c, t, dim) -> bool:
        return {type(c), type(t)} == {_StridedShard, Replicate} or (c == Replicate() and dim not in split)

    return any(isinstance(p, _SHARDS) and p.dim in strided and not allowed(c, t, p.dim)
               for c, t in zip(cur, tgt) if c != t for p in (c, t))


def _gathered_strided(placements) -> list:
    return [Replicate() if isinstance(p, _StridedShard) else p for p in placements]


def _view_groups(old: tuple, new: tuple) -> list | None:
    """The dimensions of a view, grouped: each (old dims, new dims) pair
    holds the same elements (a merge, a split, one to one, or a size-1
    dimension alone)."""
    groups, i, j = [], 0, 0
    while i < len(old) or j < len(new):
        gi, gj = [], []
        while not gi or not gj or _numel(old, gi) != _numel(new, gj):
            if gi and (not gj or _numel(old, gi) > _numel(new, gj)) or i == len(old):
                if j == len(new):
                    return None if _numel(old, gi) != _numel(new, gj) else groups + [(gi, gj)]
                gj.append(j)
                j += 1
            else:
                gi.append(i)
                i += 1
        groups.append((gi, gj))
    return groups


def _numel(shape: tuple, dims: list) -> int:
    n = 1
    for d in dims:
        n *= shape[d]
    return n


def view_placements(shape: tuple, new_shape: tuple, placements: tuple, mesh_shape: tuple, *,
                    gather: bool = False) -> list | None:
    """The placements of a view of a tensor of ``shape`` placed
    ``placements`` as ``new_shape``, in DTensor's terms, or None where the
    rule does not place it. Merged dimensions keep their shards: the
    outermost sharded one plainly, an inner one as a ``_StridedShard``
    whose factor is the local size of the dimensions before it (a factor
    of 1 is a plain shard); a split gives each shard, in mesh order, to
    the first new dimension whose outer local size is its factor and
    whose size it divides. With ``gather``, the placements the tensor
    takes before the view instead: every shard of a group of dimensions
    the view cannot keep replicated (16 heads sharded 16 ways split into
    (8, 2)), or None where the view's dimensions cannot be grouped."""
    groups = _view_groups(tuple(shape), tuple(new_shape))
    if groups is None:
        return None
    if gather:
        return [Replicate() if isinstance(p, _SHARDS) and
                any(p.dim in gi and _group_placements(shape, new_shape, placements, mesh_shape, gi, gj) is None
                    for gi, gj in groups) else p for p in placements]
    out = list(placements)
    for gi, gj in groups:
        placed = _group_placements(shape, new_shape, placements, mesh_shape, gi, gj)
        if placed is None:
            return None
        for a, p in placed.items():
            out[a] = p
    return out


def _group_placements(shape, new_shape, placements, mesh_shape, gi: list, gj: list) -> dict | None:
    """The new placement of each mesh axis that shards a dimension of the
    group ``gi`` viewed as ``gj`` (``view_placements``), or None."""
    out = {}

    def axes_of(d):
        return [a for a, p in enumerate(placements) if isinstance(p, _SHARDS) and p.dim == d]

    def count(axes):
        n = 1
        for a in axes:
            n *= mesh_shape[a]
        return n

    if not any(axes_of(d) for d in gi):
        return out
    if len(gi) == 1 and len(gj) == 1:
        for a in axes_of(gi[0]):
            out[a] = _shard_on(placements[a], gj[0])
    elif len(gj) == 1:  # a merge
        outer = 1
        for d in gi:
            axes = axes_of(d)
            if any(isinstance(placements[a], _StridedShard) for a in axes) or shape[d] % count(axes):
                return None
            for a in axes:
                out[a] = Shard(gj[0]) if outer == 1 else _StridedShard(gj[0], split_factor=outer)
            outer *= shape[d] // count(axes)
    elif len(gi) == 1:  # a split
        pending = {a: getattr(placements[a], "split_factor", 1) for a in axes_of(gi[0])}
        outer = 1
        for d in gj:
            mine = []
            for a, sf in pending.items():  # in mesh order
                if sf == outer and new_shape[d] % (count(mine) * mesh_shape[a]) == 0:
                    mine.append(a)
            for a in mine:
                out[a] = Shard(d)
                del pending[a]
            outer *= new_shape[d] // count(mine)
        if pending:
            return None
    else:
        return None
    return out


_VIEWS = {aten.view.default, aten._unsafe_view.default}
_LAYOUT_ONLY = {aten.t.default, aten.transpose.int, aten.detach.default}
_INDEXED = {aten.index.Tensor, aten.index_put.default, aten.index_put_.default}
# (the mesh's shape, the call's signature) -> the rule's plan of it, None
# where DTensor places it; filled as operations are first met, for the process
PLANS: dict = {}


def _signature(x):
    """A hashable description of an argument: a tensor's global shape,
    strides, dtype and placements (None: a plain tensor), a scalar with its
    type (an int and a float promote differently)."""
    if isinstance(x, torch.Tensor):
        return tuple(x.shape), x.stride(), x.dtype, tuple(x.placements) if isinstance(x, DTensor) else None
    if isinstance(x, (list, tuple)):
        return tuple(map(_signature, x))
    return type(x), repr(x) if isinstance(x, float) else x


def _normal(placements, ndim: int) -> list:
    """Every shard's dimension counted from 0 and every ``_StridedShard``
    of factor 1 written as the plain shard it is (the same blocks in mesh
    order), as the rule writes them."""
    out = [_shard_on(p, p.dim % ndim) if isinstance(p, _SHARDS) else p for p in placements]
    return [Shard(p.dim) if isinstance(p, _StridedShard) and p.split_factor == 1 else p for p in out]


def _operand(t):
    """``t`` with its placements ``_normal``."""
    if not isinstance(t, DTensor):
        return t
    placements = _normal(t.placements, t.ndim)
    if placements == list(t.placements):
        return t
    return DTensor.from_local(t.to_local(), t.device_mesh, placements, run_check=False, shape=t.shape,
                              stride=t.stride())


def _pointwise(func, kwargs) -> bool:
    """A pointwise operation of one output, or a cast of dtype only."""
    if func is aten._to_copy.default:
        return set(kwargs) <= {"dtype"}
    return torch.Tag.pointwise in func.tags and not func._schema.is_mutable and len(func._schema.returns) == 1


def _even(shape, placements, mesh_shape) -> bool:
    """Whether every sharded dimension of ``shape`` divides evenly over
    the axes that shard it."""
    parts = [1] * len(shape)
    for a, p in enumerate(placements):
        if isinstance(p, _SHARDS):
            parts[p.dim] *= mesh_shape[a]
    return all(n % k == 0 for n, k in zip(shape, parts))


def _contiguous_stride(shape) -> tuple[int, ...]:
    stride, acc = [], 1
    for n in reversed(tuple(shape)):
        stride.append(acc)
        acc *= n
    return tuple(reversed(stride))


def _like(t) -> torch.Tensor:
    """A meta tensor of ``t``'s global shape, strides and dtype."""
    return torch.empty_strided(t.shape, t.stride(), dtype=t.dtype, device="meta")


def _reduced(placements) -> list:
    return [Replicate() if isinstance(p, Partial) else p for p in placements]


class FixedPlacements(TorchDispatchMode):
    """Inside, the operations of DTensors on ``mesh`` that the rule above
    covers are placed by it (a plain operand counts as
    replicated, as under ``mesh_scope``); every other operation goes to
    DTensor. The rule's plan of a call (the placements each operand is
    moved to, the output's placements, global shape and strides) depends
    only on its signature (``_signature``: the operation, its operands'
    global shapes, strides, dtypes and placements, its other arguments),
    so it is made once a process and read from ``PLANS`` after, as DTensor
    caches its own. The outputs are made below autograd, without
    ``DTensor.from_local``'s autograd function (``_wrap``)."""

    def __init__(self, mesh):
        super().__init__()
        self.mesh = mesh
        self.mesh_shape = tuple(mesh.shape)
        self.replicated = [Replicate()] * mesh.ndim
        self.specs = {}

    def _wrap(self, local: torch.Tensor, placements, shape, stride) -> DTensor:
        """``local`` as this rank's block of a DTensor of global ``shape``
        and ``stride`` placed ``placements``: what ``DTensor.from_local``
        makes, without its autograd function (this runs below autograd),
        each spec made once a scope."""
        key = (tuple(placements), tuple(shape), tuple(stride), local.dtype)
        spec = self.specs.get(key)
        if spec is None:
            meta = TensorMeta(torch.Size(shape), tuple(stride), local.dtype)
            spec = self.specs[key] = DTensorSpec(self.mesh, tuple(placements), tensor_meta=meta)
        return DTensor(local, spec, requires_grad=False)

    def _dtensor(self, t: torch.Tensor) -> DTensor:
        return t if isinstance(t, DTensor) else self._wrap(t.detach(), self.replicated, t.shape, t.stride())

    def _plan(self, key, make):
        """The plan of a call with signature ``key``, made by ``make`` at
        the first such call."""
        key = (self.mesh_shape, key)
        try:
            return PLANS[key]
        except KeyError:
            plan = PLANS[key] = make()
            return plan

    def __torch_dispatch__(self, func, types, args=(), kwargs=None):
        kwargs = kwargs or {}
        if not any(isinstance(t, DTensor) for t in (*args, *kwargs.values())):
            return func(*args, **kwargs)
        # below autograd, which records the operation around this handler:
        # DTensor's own autograd functions (``from_local``, ``to_local``,
        # ``redistribute``) record nothing here
        with torch.no_grad():
            return self._placed(func, args, kwargs)

    def _placed(self, func, args, kwargs):
        out = None
        if func in _LABELS and not kwargs:
            return self._product(func, *map(_operand, args))
        if func in _VIEWS:
            out = self._view(func, _operand(args[0]), args[1])
        elif func in _LAYOUT_ONLY:
            out = self._layout_only(func, _operand(args[0]), args[1:])
        elif func is aten.index_put.default:
            out = self._index_put(*map(_operand, args[:1]), [_operand(t) for t in args[1]], *args[2:])
            if out is None:
                args = (args[0], [self._one_axis_a_dim(t) for t in args[1]], *args[2:])
        elif func in _INDEXED:
            args = (args[0], [self._one_axis_a_dim(t) for t in args[1]], *args[2:])
        elif func is aten.flip.default:
            out = self._flip(_operand(args[0]), args[1])
        elif func is aten.constant_pad_nd.default:
            out = self._pad(_operand(args[0]), *args[1:])
        elif _pointwise(func, kwargs):
            out = self._pointwise(func, args, kwargs)
        if out is not None:
            return out
        try:
            return func(*args, **kwargs)
        except Exception as e:
            placed = [(tuple(t.shape), tuple(t.placements)) for t in args if isinstance(t, DTensor)]
            e.add_note(f"in {func} of {placed} on a mesh of {self.mesh.ndim} axes, left to DTensor")
            raise

    def _view(self, func, x, shape, *, gather: bool = True) -> DTensor | None:
        """A view placed by ``view_placements`` (DTensor's own rule cannot
        make a strided shard in torch 2.11, and splits a dimension sharded
        on three axes wrongly in torch 2.13), else None. With ``gather``,
        the shards of dimensions the view cannot keep are gathered first,
        as DTensor's rule gathers them on a 2-D mesh."""
        plan = self._plan((func, _signature(x), tuple(shape), gather), lambda: self._view_plan(func, x, shape, gather))
        if plan is None:
            return None
        kept, out, local, like = plan
        if kept is not None:
            x = self._redistribute(x, kept)
        return self._wrap(func(x.to_local(), local), out, *like)

    def _view_plan(self, func, x, shape, gather: bool):
        """(the placements ``x`` is moved to first or None, the view's
        placements, its local shape, its global shape and strides)."""
        meta = func(_like(x), shape)
        placements, kept = tuple(x.placements), None
        out = view_placements(tuple(x.shape), tuple(meta.shape), placements, self.mesh_shape)
        if out is None and gather:
            kept = view_placements(tuple(x.shape), tuple(meta.shape), placements, self.mesh_shape, gather=True)
            if kept is None or _moves_a_strided_dim(placements, kept):
                return None
            out = view_placements(tuple(x.shape), tuple(meta.shape), tuple(kept), self.mesh_shape)
        if out is None:
            return None
        if not (_even(x.shape, kept or placements, self.mesh_shape) and _even(meta.shape, out, self.mesh_shape)):
            return None  # an uneven shard: the ranks' blocks differ, and DTensor's own rule places them
        local = list(meta.shape)
        for a, p in enumerate(out):
            if isinstance(p, _SHARDS):
                local[p.dim] //= self.mesh_shape[a]
        return kept, out, local, (meta.shape, meta.stride())

    def _layout_only(self, func, x, rest) -> DTensor | None:
        """A transpose or a detach of a tensor that holds a strided shard:
        the same blocks, the dimensions renamed; else None."""

        def make():
            if not any(isinstance(p, _StridedShard) for p in x.placements):
                return None
            meta = func(_like(x), *rest)
            order = list(range(x.ndim))
            if func is not aten.detach.default:
                d0, d1 = rest if len(rest) == 2 else (0, 1)
                order[d0 % x.ndim], order[d1 % x.ndim] = order[d1 % x.ndim], order[d0 % x.ndim]
            out = [_shard_on(p, order.index(p.dim)) if isinstance(p, _SHARDS) else p for p in x.placements]
            return out, (meta.shape, meta.stride())

        plan = self._plan((func, _signature(x), tuple(rest)), make)
        if plan is None:
            return None
        out, like = plan
        return self._wrap(func(x.to_local(), *rest), out, *like)

    def _flip(self, x, dims) -> DTensor | None:
        """A flip of dimensions no axis splits (torch 2.11's DTensor has no
        rule for ``flip``: the backward of a ``cumsum``), else None."""

        def make():
            if any(isinstance(p, _SHARDS) and p.dim in [d % x.ndim for d in dims] for p in x.placements):
                return None
            like = aten.flip.default(_like(x), dims)
            return like.shape, like.stride()

        like = self._plan((aten.flip.default, _signature(x), tuple(dims)), make)
        if like is None:
            return None
        return self._wrap(aten.flip.default(x.to_local(), dims), x.placements, *like)

    def _index_put(self, x, indices, values, accumulate=False) -> DTensor | None:
        """An accumulating index put of one index tensor into a replicated
        ``x`` (the embedding's backward), else None. The index follows the
        values: where they shard one of its dimensions it is cut alike and
        each rank adds its own rows (a partial sum, reduced before it
        leaves); where they shard a trailing dimension, ``x``'s is sharded
        alike and the index gathered."""
        if not accumulate or len(indices) != 1 or not isinstance(indices[0], torch.Tensor):
            return None
        if any(not isinstance(p, Replicate) for p in getattr(x, "placements", self.replicated)):
            return None
        x, idx, values = self._dtensor(x), self._dtensor(indices[0]), self._dtensor(values)
        n = idx.ndim
        tx, ti, out = [], [], []
        for pv in values.placements:  # the index follows the values
            if isinstance(pv, _SHARDS) and pv.dim < n:
                tx.append(Replicate())
                ti.append(pv)
                out.append(Partial())
            elif isinstance(pv, Shard):
                tx.append(Shard(1 + pv.dim - n))
                ti.append(Replicate())
                out.append(Shard(1 + pv.dim - n))
            elif isinstance(pv, (Replicate, Partial)):
                tx.append(Replicate())
                ti.append(Replicate())
                out.append(pv)
            else:
                return None
        if _moves_a_strided_dim(idx.placements, ti):
            return None
        local = aten.index_put.default(self._redistribute(x, tx).to_local(), [self._redistribute(idx, ti).to_local()],
                                       values.to_local(), accumulate)
        res = self._wrap(local, out, x.shape, x.stride())
        return self._redistribute(res, _reduced(out))

    def _pad(self, x, pad, value=0) -> DTensor:
        """A constant pad, each padded dimension gathered first (torch
        2.11's DTensor fails to plan the pad of a sharded sequence)."""

        def make():
            padded = {x.ndim - 1 - i // 2 for i, n in enumerate(pad) if n}
            want = [Replicate() if isinstance(p, _SHARDS) and p.dim in padded else p for p in x.placements]
            like = aten.constant_pad_nd.default(_like(x), pad, value)
            return want, (like.shape, like.stride())

        want, like = self._plan((aten.constant_pad_nd.default, _signature(x), tuple(pad), _signature(value)), make)
        x = self._redistribute(x, want)
        return self._wrap(aten.constant_pad_nd.default(x.to_local(), pad, value), want, *like)

    def _one_axis_a_dim(self, t):
        """An index tensor whose dimensions are each split on one axis at
        most (the first): torch 2.11's DTensor refuses an index dimension
        split on two (``index``), or writes a shard it cannot read
        (``index_put``, the embedding's backward)."""
        if not isinstance(t, DTensor):
            return t
        t = _operand(t)
        seen, want = set(), []
        for p in t.placements:
            split = isinstance(p, _SHARDS)
            want.append(Replicate() if split and p.dim in seen else p)
            if split:
                seen.add(p.dim)
        return self._redistribute(t, want)

    def _redistribute(self, t: DTensor, target: list) -> DTensor:
        """``t`` placed ``target``, its collectives counted in a running
        ``step_analysis.analyze_step``. A dimension that holds a strided
        shard is moved in its unmerged view (outer, inner), where its shards
        are plain: DTensor moves plain shards right in torch 2.11 and 2.13,
        and a strided one in neither (2.13 re-split one wrongly, 2.11 cannot
        read one)."""
        target = list(target)
        if list(t.placements) == target:
            return t
        if t.requires_grad:  # DTensor's redistribute would ``detach_`` its output here, which torch 2.11 lacks
            t = self._wrap(t.to_local(), t.placements, t.shape, t.stride())
        with counting_collectives():
            return self._moved(t, target)

    def _moved(self, t: DTensor, target: list) -> DTensor:
        strided = {p.dim for p in (*t.placements, *target) if isinstance(p, _StridedShard)}
        if not strided:
            return t.redistribute(self.mesh, target)
        if len(strided) > 1:
            raise NotImplementedError(f"moving strided shards of two dimensions: {t.placements} -> {target}")
        d = strided.pop()
        side = t.placements if any(isinstance(p, _StridedShard) for p in t.placements) else target
        outer = 1  # the merged outer size: the strided factor times the plain shards'
        for a, p in enumerate(side):
            if isinstance(p, _StridedShard) and p.dim == d:
                outer = p.split_factor
        for a, p in enumerate(side):
            if type(p) is Shard and p.dim == d:
                outer *= self.mesh_shape[a]
        unmerged = (*t.shape[:d], outer, t.shape[d] // outer, *t.shape[d + 1:])
        there = view_placements(tuple(t.shape), unmerged, tuple(target), self.mesh_shape)
        u = self._view(aten.view.default, t, unmerged, gather=False)
        if there is None or u is None:
            raise NotImplementedError(f"moving a strided shard: {t.placements} -> {target} for {tuple(t.shape)}")
        back = self._view(aten.view.default, u.redistribute(self.mesh, there), tuple(t.shape), gather=False)
        if back is None or list(back.placements) != target:
            raise AssertionError(f"{t.placements} -> {target} came back {back and back.placements}")
        return back

    def _product(self, func, a, b):
        a, b = self._dtensor(a), self._dtensor(b)

        def make():
            pa, pb = a.placements, b.placements
            pre = None
            ta, tb, to = product_placements(func, pa, pb)
            if _moves_a_strided_dim(pa, ta) or _moves_a_strided_dim(pb, tb):
                pre = _gathered_strided(pa), _gathered_strided(pb)
                ta, tb, to = product_placements(func, *pre)
            shape = torch.Size((*a.shape[:-1], b.shape[-1]))
            return pre, ta, tb, to, shape, _contiguous_stride(shape)

        pre, ta, tb, to, shape, stride = self._plan((func, _signature(a), _signature(b)), make)
        if pre is not None:
            a, b = self._redistribute(a, pre[0]), self._redistribute(b, pre[1])
        a, b = self._redistribute(a, ta), self._redistribute(b, tb)
        out = self._wrap(func(a.to_local(), b.to_local()), to, shape, stride)
        return self._redistribute(out, _reduced(to))

    def _pointwise(self, func, args, kwargs) -> DTensor | None:
        """The operation on each rank's blocks, its operands' partial sums
        reduced first, or None where the rule does not place it. On meta
        tensors (the dry run) a result is its shape and strides alone, which
        the local operands' decide: each is computed once a plan."""
        args, kwargs = tuple(map(_operand, args)), {k: _operand(v) for k, v in kwargs.items()}
        tensors = [t for t in (*args, *kwargs.values()) if isinstance(t, torch.Tensor)]

        def call(swap):
            return func(*(swap[id(x)] if isinstance(x, torch.Tensor) else x for x in args),
                        **{k: swap[id(v)] if isinstance(v, torch.Tensor) else v for k, v in kwargs.items()})

        def make():
            reduced = [_reduced(getattr(t, "placements", self.replicated)) for t in tensors]
            shapes = [tuple(t.shape) for t in tensors]
            out = pointwise_placements(shapes, reduced)
            if out is None:
                return None
            n = len(torch.broadcast_shapes(*shapes))
            wants = [_operand_placements(s, out, n) for s in shapes]
            if any(_moves_a_strided_dim(r, w) for r, w in zip(reduced, wants)):
                return None
            like = call({id(t): _like(t) for t in tensors})  # the output's global shape, strides and dtype
            return reduced, wants, out, like, {}

        plan = self._plan((func, _signature(args), _signature(tuple(kwargs.items()))), make)
        if plan is None:
            return None
        reduced, wants, out, like, on_meta = plan
        local = {id(t): self._redistribute(self._redistribute(self._dtensor(t), r), w).to_local()
                 for t, r, w in zip(tensors, reduced, wants)}
        key = tuple((tuple(x.shape), x.stride()) for x in local.values()) if all(
            x.is_meta for x in local.values()) else None
        if key in on_meta:
            result = torch.empty_strided(*on_meta[key], dtype=like.dtype, device="meta")
        else:
            result = call(local)
            if key is not None:
                on_meta[key] = result.shape, result.stride()
        return self._wrap(result, out, like.shape, like.stride())
