"""Shared AST machinery for the port's source-level checkers.

Two things live here because every checker needs them:

* :class:`Module` / :class:`ModuleCache` — parse each file once (AST, raw
  lines, annotation allowlist, dotted module name, whether it imports
  torch) no matter how many checkers scan it; ``files`` never returns a
  path under a ``fixtures`` directory;
* the repo-local import graph (:func:`repo_imports`, :func:`reachable`) for
  the collective-free reachability check, with ``if TYPE_CHECKING:`` blocks
  skipped — typing-only imports don't execute and must not create edges.
  Dotted names are taken under ``src/``, so a closure from ``repro_torch``
  roots only reaches ``repro`` through an import of it, which the port has
  none of.

The JAX package's twin also finds traced scopes (functions wrapped by
``jit``/``vmap``/``pallas_call``, whose bodies run under a JAX trace). The
port has no traced scopes: its programs are Python closures over torch
calls that run eagerly, so there is nothing here to find them, and the
host checker's cast rule is stated over tensor expressions instead
(:mod:`.checkers`).
"""

from __future__ import annotations

import ast
from dataclasses import dataclass
from pathlib import Path

from .findings import Annotations, Finding, line_hash, scan_annotations

__all__ = [
    "Module",
    "ModuleCache",
    "attach_parents",
    "repo_imports",
    "reachable",
    "root_name",
    "call_name",
    "src_finding",
]

_FUNC_DEFS = (ast.FunctionDef, ast.AsyncFunctionDef)


@dataclass
class Module:
    path: Path
    rel: str  # repo-relative posix path
    source: str
    lines: list[str]
    tree: ast.Module
    func_ranges: list[tuple[int, int]]
    annotations: Annotations
    imports_torch: bool
    name: str  # dotted module name ("repro_torch.lbm.halo"), "" outside src/
    is_pkg: bool


class ModuleCache:
    """Parse-once cache keyed by absolute path."""

    def __init__(self, repo_root: Path):
        self.repo_root = repo_root
        self._mods: dict[Path, Module | None] = {}

    def get(self, path: Path) -> Module | None:
        path = path.resolve()
        if path not in self._mods:
            self._mods[path] = self._parse(path)
        return self._mods[path]

    def _parse(self, path: Path) -> Module | None:
        try:
            source = path.read_text()
            tree = ast.parse(source)
        except (OSError, SyntaxError):
            return None
        attach_parents(tree)
        func_ranges = [
            (n.lineno, n.end_lineno or n.lineno)
            for n in ast.walk(tree)
            if isinstance(n, _FUNC_DEFS)
        ]
        rel = path.relative_to(self.repo_root).as_posix()
        return Module(
            path=path,
            rel=rel,
            source=source,
            lines=source.splitlines(),
            tree=tree,
            func_ranges=func_ranges,
            annotations=scan_annotations(source, func_ranges),
            imports_torch=_imports_torch(tree),
            name=_dotted_name(rel),
            is_pkg=path.name == "__init__.py",
        )

    def files(self, roots: list[str], exclude: tuple[str, ...] = ("fixtures",)) -> list[Path]:
        """Expand configured path roots (files or directories) to .py files."""
        out: set[Path] = set()
        for root in roots:
            p = (self.repo_root / root).resolve()
            if p.is_file():
                out.add(p)
            elif p.is_dir():
                for f in p.rglob("*.py"):
                    rel_parts = f.relative_to(self.repo_root).parts
                    if not any(part in exclude for part in rel_parts):
                        out.add(f)
        return sorted(out)

    def src_modules(self) -> dict[str, Module]:
        """Dotted-name map of every module under src/ (the import graph)."""
        out: dict[str, Module] = {}
        for f in self.files(["src"]):
            mod = self.get(f)
            if mod is not None and mod.name:
                out[mod.name] = mod
        return out


def _dotted_name(rel: str) -> str:
    parts = rel.split("/")
    if parts[0] != "src" or not parts[-1].endswith(".py"):
        return ""
    parts = parts[1:]
    if parts[-1] == "__init__.py":
        parts = parts[:-1]
    else:
        parts[-1] = parts[-1][:-3]
    return ".".join(parts)


def _imports_torch(tree: ast.Module) -> bool:
    for node in ast.walk(tree):
        if isinstance(node, ast.Import):
            if any(a.name == "torch" or a.name.startswith("torch.") for a in node.names):
                return True
        elif isinstance(node, ast.ImportFrom):
            if node.module and (node.module == "torch" or node.module.startswith("torch.")):
                return True
    return False


def attach_parents(tree: ast.AST) -> None:
    for node in ast.walk(tree):
        for child in ast.iter_child_nodes(node):
            child.parent = node  # type: ignore[attr-defined]


def ancestors(node: ast.AST):
    cur = getattr(node, "parent", None)
    while cur is not None:
        yield cur
        cur = getattr(cur, "parent", None)


def enclosing_def(node: ast.AST) -> ast.AST | None:
    for a in ancestors(node):
        if isinstance(a, _FUNC_DEFS):
            return a
    return None


def _last_name(expr: ast.expr) -> str:
    if isinstance(expr, ast.Name):
        return expr.id
    if isinstance(expr, ast.Attribute):
        return expr.attr
    return ""


def call_name(call: ast.Call) -> str:
    """Last path component of a call's callee (``torch.cuda.synchronize``
    -> ``synchronize``)."""
    return _last_name(call.func)


def root_name(expr: ast.expr) -> str:
    """Leftmost Name of an attribute/subscript chain (``a.b[c].d`` -> ``a``)."""
    while isinstance(expr, (ast.Attribute, ast.Subscript)):
        expr = expr.value
    return expr.id if isinstance(expr, ast.Name) else ""


# -- repo-local import graph -------------------------------------------------------


def _is_type_checking_if(node: ast.stmt) -> bool:
    return isinstance(node, ast.If) and _last_name(node.test) == "TYPE_CHECKING"


def _iter_stmts(body: list[ast.stmt]):
    """All statements, skipping ``if TYPE_CHECKING:`` bodies (typing-only
    imports never execute — they must not create reachability edges)."""
    for stmt in body:
        if _is_type_checking_if(stmt):
            yield from _iter_stmts(stmt.orelse)
            continue
        yield stmt
        for attr in ("body", "orelse", "finalbody", "handlers"):
            sub = getattr(stmt, attr, None)
            if not sub:
                continue
            if attr == "handlers":
                for h in sub:
                    yield from _iter_stmts(h.body)
            else:
                yield from _iter_stmts(sub)


def repo_imports(mod: Module, known: set[str]) -> set[str]:
    """Dotted names of repo modules ``mod`` imports (resolved against
    ``known``, the full src/ module map — ``from . import x`` may name either
    a submodule or an attribute, so both candidates are tried)."""
    parts = mod.name.split(".") if mod.name else []
    pkg = parts if mod.is_pkg else parts[:-1]
    out: set[str] = set()

    def add(cand: str) -> None:
        # resolve to the longest known prefix (importing repro_torch.core.comm
        # also executes repro_torch.core/__init__)
        bits = cand.split(".")
        for i in range(len(bits), 0, -1):
            name = ".".join(bits[:i])
            if name in known:
                out.add(name)
                return

    for stmt in _iter_stmts(mod.tree.body):
        if isinstance(stmt, ast.Import):
            for a in stmt.names:
                add(a.name)
        elif isinstance(stmt, ast.ImportFrom):
            if stmt.level:
                base = pkg[: len(pkg) - (stmt.level - 1)]
                base_name = ".".join(base + (stmt.module.split(".") if stmt.module else []))
            else:
                base_name = stmt.module or ""
            if not base_name:
                continue
            add(base_name)
            for a in stmt.names:
                add(f"{base_name}.{a.name}")
    return out


def reachable(
    roots: list[str], modules: dict[str, Module], exclude: set[str]
) -> dict[str, str]:
    """BFS the import graph from ``roots``; returns module -> predecessor
    ("" for roots). ``exclude`` names are never entered (control-plane
    modules sanctioned to use collectives)."""
    seen: dict[str, str] = {}
    frontier = [r for r in roots if r in modules and r not in exclude]
    for r in frontier:
        seen[r] = ""
    while frontier:
        nxt: list[str] = []
        for name in frontier:
            for dep in sorted(repo_imports(modules[name], set(modules))):
                if dep in seen or dep in exclude:
                    continue
                seen[dep] = name
                nxt.append(dep)
        frontier = nxt
    return seen


def import_chain(name: str, seen: dict[str, str]) -> str:
    chain = [name]
    while seen.get(chain[-1]):
        chain.append(seen[chain[-1]])
    return " <- ".join(chain)


def src_finding(
    mod: Module,
    checker: str,
    lineno: int,
    message: str,
    fix_hint: str = "",
    severity: str = "error",
) -> Finding:
    text = mod.lines[lineno - 1] if 0 < lineno <= len(mod.lines) else ""
    return Finding(
        checker=checker,
        severity=severity,
        path=mod.rel,
        line=lineno,
        message=message,
        fix_hint=fix_hint,
        line_hash=line_hash(text),
    )
