"""The port's source-level checkers: host-transfer, collective-free and
program builds in loops.

Each checker is a function ``(cfg, cache) -> list[Finding]`` registered in
:data:`CHECKERS`; :func:`run` drives any subset and folds in the
annotation-hygiene findings (an ``-ok()`` with an empty reason is itself an
error). The JAX package's fourth checker, ``donation`` (no read of a buffer
after a program consumed it), has no counterpart: the port donates nothing,
since its pull stencils ping-pong between two buffers and every program
returns fresh tensors.

* **host** — device->host syncs in the hot-path modules (config
  ``host_transfer``): ``.item()``, ``.cpu()``, ``.tolist()`` and
  ``.numpy()``; ``.to("cpu")`` and ``.to(device="cpu")``; any call named
  ``synchronize`` (``torch.cuda.synchronize``, the port's own
  :func:`~repro_torch.device.synchronize`, ``Event``/``Stream``
  ``.synchronize()``); ``np.asarray``/``np.array`` of anything that is not
  an obvious host value, in modules that import torch (``lbm/halo.py`` is
  numpy only: there the call is a host copy, not a sync); and
  ``float()``/``int()``/``bool()`` of a *tensor expression*. The cast rule
  is conservative, by design flagging only what it can see is a tensor:
  an expression is a tensor expression when it is a call of a ``torch``
  function other than the few that return host values (``torch.device``,
  ``torch.Size``, ``torch.is_tensor``, ``torch.cuda.device_count``, ...),
  or an attribute, subscript or method chain on a *tensor name*, or an
  arithmetic or comparison over one of those; a tensor name is, within
  one function, a parameter annotated ``Tensor`` or a name bound to a
  tensor expression. A chain ending in tensor metadata (``.shape``,
  ``.dtype``, ``.device``, ``.numel()``, ``.element_size()``, ...) is a
  host value. So ``int(x.sum())`` of a tensor ``x`` is flagged, while
  ``int(CellType.WALL)``, ``float(c[q] @ uw)`` of numpy lattice constants
  and ``int(t.shape[0])`` stay legal.
* **collective** — no collective in any module reachable from the stepping
  roots through the repo import graph (control-plane modules excluded by
  config): a call named in ``collectives`` on any callee (``all_reduce``,
  ``allgather``, ``broadcast``, ``barrier``, ``ppermute``, ...) unless its
  enclosing def has that name (the fabric implementing itself), and a call
  named in ``distributed`` (``send``, ``recv``, their ``i`` forms,
  ``gather``, ...) where the callee resolves to ``torch.distributed``. The
  host ``Comm.send`` is the simulated p2p fabric and stays legal.
* **retrace** — a call of a program factory (config ``retrace.factories``)
  inside a ``for``/``while`` body or a comprehension, unless it builds
  under a keyed cache: lexically inside a ``with`` that opens a
  ``build:*`` span (the span the runtime
  :class:`~.retrace.RetraceSentinel` counts) or inside a factory's own
  body (a program composed of sub-programs). A build outside both runs as
  often as its loop does.
"""

from __future__ import annotations

import ast
from pathlib import Path

from .astutil import (
    Module,
    ModuleCache,
    ancestors,
    call_name,
    enclosing_def,
    import_chain,
    reachable,
    root_name,
    src_finding,
    _FUNC_DEFS,
    _last_name,
)
from .config import LintConfig
from .findings import Finding

__all__ = ["CHECKERS", "run", "annotation_findings"]

_SYNC_METHODS = {"item", "cpu", "tolist", "numpy"}
_HOST_CASTS = {"float", "int", "bool"}
_NP_COPY = {"asarray", "array"}
# callees whose result is trivially a host value
_HOST_PRODUCERS = {
    "list", "tuple", "dict", "sorted", "range", "len", "zip", "enumerate",
    "sum", "min", "max", "str", "repr",
}
# torch functions that return host values, not tensors
_TORCH_HOST = {
    "device", "Size", "dtype", "is_tensor", "is_floating_point", "is_available",
    "device_count", "current_device", "get_device_name", "get_device_properties",
    "finfo", "iinfo", "numel",
}
# tensor metadata: attributes and methods whose result lives on the host
_TENSOR_META = {
    "shape", "dtype", "device", "ndim", "is_cuda", "layout", "requires_grad",
    "numel", "dim", "size", "element_size", "data_ptr", "stride", "nbytes",
    "is_contiguous", "get_device",
}
_LOOPS = (ast.For, ast.AsyncFor, ast.While, ast.ListComp, ast.SetComp, ast.DictComp, ast.GeneratorExp)


def _allowed(mod: Module, node: ast.AST, checker: str) -> bool:
    return mod.annotations.allows(getattr(node, "lineno", 0), checker)


def _is_host_value(expr: ast.expr) -> bool:
    """Expressions that cannot be device tensors: literals, displays,
    comprehensions, and calls to plain host builtins."""
    if isinstance(
        expr,
        (
            ast.Constant, ast.List, ast.Tuple, ast.Dict, ast.Set,
            ast.ListComp, ast.SetComp, ast.DictComp, ast.GeneratorExp,
            ast.JoinedStr,
        ),
    ):
        return True
    if isinstance(expr, ast.Call) and call_name(expr) in _HOST_PRODUCERS:
        return True
    return False


def _np_base(expr: ast.expr) -> bool:
    return isinstance(expr, ast.Attribute) and _last_name(expr.value) in ("np", "numpy", "onp")


def _dotted(expr: ast.expr) -> str:
    """``a.b.c`` for a pure attribute chain over a name, else ""."""
    parts = []
    while isinstance(expr, ast.Attribute):
        parts.append(expr.attr)
        expr = expr.value
    if not isinstance(expr, ast.Name):
        return ""
    parts.append(expr.id)
    return ".".join(reversed(parts))


def _is_cpu_device(expr: ast.expr) -> bool:
    """``"cpu"`` (or ``"cpu:0"``), or ``torch.device("cpu")``."""
    if isinstance(expr, ast.Constant) and isinstance(expr.value, str):
        return expr.value.split(":")[0] == "cpu"
    if isinstance(expr, ast.Call) and _dotted(expr.func) == "torch.device" and expr.args:
        return _is_cpu_device(expr.args[0])
    return False


def _to_cpu(call: ast.Call) -> bool:
    if not (isinstance(call.func, ast.Attribute) and call.func.attr == "to"):
        return False
    if call.args and _is_cpu_device(call.args[0]):
        return True
    return any(k.arg == "device" and _is_cpu_device(k.value) for k in call.keywords)


class _TensorNames:
    """The tensor names of each function (see the module docstring)."""

    def __init__(self, tree: ast.Module):
        self._by_def: dict[ast.AST, set[str]] = {}
        for d in ast.walk(tree):
            if isinstance(d, _FUNC_DEFS):
                self._by_def[d] = self._collect(d)

    @staticmethod
    def _annotated_tensor(arg: ast.arg) -> bool:
        ann = arg.annotation
        if ann is None:
            return False
        text = ast.unparse(ann)
        return any(part.strip().split(".")[-1] == "Tensor" for part in text.replace("|", ",").split(","))

    def _collect(self, d: ast.AST) -> set[str]:
        args = d.args
        names = {
            a.arg for a in (*args.posonlyargs, *args.args, *args.kwonlyargs)
            if self._annotated_tensor(a)
        }
        assigns = [
            n for n in ast.walk(d)
            if isinstance(n, (ast.Assign, ast.AnnAssign)) and n.value is not None
            and enclosing_def(n) is d
        ]
        changed = True
        while changed:  # a name bound to an expression over another tensor name
            changed = False
            for n in assigns:
                if not self.is_tensor(n.value, names):
                    continue
                targets = n.targets if isinstance(n, ast.Assign) else [n.target]
                for t in targets:
                    if isinstance(t, ast.Name) and t.id not in names:
                        names.add(t.id)
                        changed = True
        return names

    def names_at(self, node: ast.AST) -> set[str]:
        out: set[str] = set()
        d = enclosing_def(node)
        while d is not None:  # closures see their enclosing functions' names
            out |= self._by_def.get(d, set())
            d = enclosing_def(d)
        return out

    @classmethod
    def is_tensor(cls, expr: ast.expr, names: set[str]) -> bool:
        if isinstance(expr, ast.BinOp):
            return cls.is_tensor(expr.left, names) or cls.is_tensor(expr.right, names)
        if isinstance(expr, ast.UnaryOp):
            return cls.is_tensor(expr.operand, names)
        if isinstance(expr, ast.Compare):
            return any(cls.is_tensor(e, names) for e in (expr.left, *expr.comparators))
        if isinstance(expr, ast.Call):
            if root_name(expr.func) == "torch":
                return call_name(expr) not in _TORCH_HOST
            if isinstance(expr.func, ast.Attribute):
                if expr.func.attr in _TENSOR_META:
                    return False
                return cls.is_tensor(expr.func.value, names)
            return False
        if isinstance(expr, ast.Attribute):
            if expr.attr in _TENSOR_META:
                return False
            return cls.is_tensor(expr.value, names)
        if isinstance(expr, ast.Subscript):
            return cls.is_tensor(expr.value, names)
        if isinstance(expr, ast.Name):
            return expr.id in names
        return False


def check_host_transfer(cfg: LintConfig, cache: ModuleCache) -> list[Finding]:
    sec = cfg.section("host_transfer")
    out: list[Finding] = []
    for path in cache.files(sec["paths"]):
        mod = cache.get(path)
        if mod is None:
            continue
        tensors = _TensorNames(mod.tree)
        for node in ast.walk(mod.tree):
            if not isinstance(node, ast.Call) or _allowed(mod, node, "host"):
                continue
            name = call_name(node)
            if isinstance(node.func, ast.Attribute) and name in _SYNC_METHODS:
                out.append(src_finding(
                    mod, "host", node.lineno,
                    f".{name}() forces a device->host copy and sync",
                    "keep the value on the device, or annotate the "
                    "sanctioned sync with '# repro: host-ok(reason)'",
                ))
            elif _to_cpu(node):
                out.append(src_finding(
                    mod, "host", node.lineno,
                    ".to('cpu') forces a device->host copy and sync",
                    "keep the value on the device, or annotate the "
                    "sanctioned copy with '# repro: host-ok(reason)'",
                ))
            elif name == "synchronize":
                out.append(src_finding(
                    mod, "host", node.lineno,
                    "synchronize() stalls the host until the device drains",
                    "only fences may wait; annotate with "
                    "'# repro: host-ok(reason)' if this fence is the contract",
                ))
            elif (
                name in _NP_COPY
                and _np_base(node.func)
                and mod.imports_torch
                and node.args
                and not _is_host_value(node.args[0])
            ):
                out.append(src_finding(
                    mod, "host", node.lineno,
                    f"np.{name}() on a possibly device-resident value is an "
                    "implicit device->host transfer",
                    "use torch ops on the device, or annotate the sanctioned "
                    "host copy with '# repro: host-ok(reason)'",
                ))
            elif (
                name in _HOST_CASTS
                and isinstance(node.func, ast.Name)
                and node.args
                and _TensorNames.is_tensor(node.args[0], tensors.names_at(node))
            ):
                out.append(src_finding(
                    mod, "host", node.lineno,
                    f"{name}() of a tensor expression copies it to the host "
                    "and syncs",
                    "keep the computation in torch ops on the device",
                ))
    return out


# -- collective-free stepping ------------------------------------------------------


def _distributed_aliases(tree: ast.Module) -> tuple[set[str], dict[str, str]]:
    """Names bound to the ``torch.distributed`` module, and bare names
    imported from it (local name -> function name)."""
    modules = {"torch.distributed"}
    funcs: dict[str, str] = {}
    for node in ast.walk(tree):
        if isinstance(node, ast.Import):
            for a in node.names:
                if a.name == "torch.distributed" and a.asname:
                    modules.add(a.asname)
        elif isinstance(node, ast.ImportFrom) and node.module:
            for a in node.names:
                if node.module == "torch" and a.name == "distributed":
                    modules.add(a.asname or a.name)
                elif node.module == "torch.distributed":
                    funcs[a.asname or a.name] = a.name
    return modules, funcs


def _distributed_call(call: ast.Call, modules: set[str], funcs: dict[str, str]) -> str:
    """The ``torch.distributed`` function ``call`` resolves to, else ""."""
    if isinstance(call.func, ast.Attribute) and _dotted(call.func.value) in modules:
        return call.func.attr
    if isinstance(call.func, ast.Name):
        return funcs.get(call.func.id, "")
    return ""


def check_collective(cfg: LintConfig, cache: ModuleCache) -> list[Finding]:
    sec = cfg.section("collective")
    collectives = set(sec["collectives"])
    distributed = collectives | set(sec.get("distributed", ()))
    modules = cache.src_modules()
    seen = reachable(list(sec["stepping_modules"]), modules, set(sec["exclude"]))
    out: list[Finding] = []
    for name in sorted(seen):
        mod = modules[name]
        dist_modules, dist_funcs = _distributed_aliases(mod.tree)
        for node in ast.walk(mod.tree):
            if not isinstance(node, ast.Call):
                continue
            callee = call_name(node)
            dist = _distributed_call(node, dist_modules, dist_funcs)
            if dist in distributed:
                what = f"torch.distributed.{dist}"
            elif callee in collectives:
                # a collective implementing itself in the fabric
                # (Comm.allreduce's body) is the provider, not a caller
                encl = enclosing_def(node)
                if encl is not None and encl.name in collectives:
                    continue
                what = callee
            else:
                continue
            if _allowed(mod, node, "collective"):
                continue
            out.append(src_finding(
                mod, "collective", node.lineno,
                f"collective '{what}' reachable from the stepping path "
                f"(import chain: {import_chain(name, seen)}) — stepping "
                "must be p2p-only (paper §2, Table 1)",
                "move the collective to a control-plane module (AMR cycle), "
                "or annotate with '# repro: collective-ok(reason)'",
            ))
    return out


# -- program builds in loops --------------------------------------------------------


def _opens_build_span(node: ast.AST) -> bool:
    if not isinstance(node, (ast.With, ast.AsyncWith)):
        return False
    for item in node.items:
        ctx = item.context_expr
        if (
            isinstance(ctx, ast.Call)
            and call_name(ctx) == "span"
            and ctx.args
            and isinstance(ctx.args[0], ast.Constant)
            and isinstance(ctx.args[0].value, str)
            and ctx.args[0].value.startswith("build:")
        ):
            return True
    return False


def check_retrace(cfg: LintConfig, cache: ModuleCache) -> list[Finding]:
    sec = cfg.section("retrace")
    factories = set(sec["factories"])
    out: list[Finding] = []
    for path in cache.files(sec["paths"]):
        mod = cache.get(path)
        if mod is None:
            continue
        for node in ast.walk(mod.tree):
            if not isinstance(node, ast.Call) or call_name(node) not in factories:
                continue
            up = list(ancestors(node))
            if not any(isinstance(a, _LOOPS) for a in up):
                continue
            if any(_opens_build_span(a) for a in up):
                continue  # a keyed cache's build, counted by the sentinel
            if any(isinstance(a, _FUNC_DEFS) and a.name in factories for a in up):
                continue  # a factory composing its sub-programs
            if _allowed(mod, node, "retrace"):
                continue
            out.append(src_finding(
                mod, "retrace", node.lineno,
                f"program factory '{call_name(node)}' called inside a loop "
                "outside a keyed cache: every iteration builds the program "
                "again",
                "build once under a cache keyed on (storage version, "
                "levels) inside a 'build:*' span, or hoist the build out "
                "of the loop",
            ))
    return out


# -- runner ------------------------------------------------------------------------


def annotation_findings(cfg: LintConfig, cache: ModuleCache) -> list[Finding]:
    """Empty-reason annotations across every scanned file."""
    paths: set[Path] = set()
    for sec_name in ("host_transfer", "retrace"):
        paths.update(cache.files(cfg.section(sec_name)["paths"]))
    out: list[Finding] = []
    for path in sorted(paths):
        mod = cache.get(path)
        if mod is None:
            continue
        for lineno, checker in mod.annotations.empty:
            out.append(src_finding(
                mod, "annotation", lineno,
                f"'{checker}-ok()' has an empty reason — every sanctioned "
                "finding must document why it is sanctioned",
                f"write '# repro: {checker}-ok(<why this is safe>)'",
            ))
    return out


CHECKERS = {
    "host": check_host_transfer,
    "collective": check_collective,
    "retrace": check_retrace,
}


def run(cfg: LintConfig, names: list[str] | None = None, cache: ModuleCache | None = None) -> list[Finding]:
    cache = cache or ModuleCache(cfg.repo_root)
    names = names or list(CHECKERS)
    out: list[Finding] = []
    for name in names:
        out.extend(CHECKERS[name](cfg, cache))
    out.extend(annotation_findings(cfg, cache))
    return sorted(out, key=lambda f: (f.path, f.line, f.checker))
