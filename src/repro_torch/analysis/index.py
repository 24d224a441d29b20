"""Shared file/symbol index: one parse per file, queried by every rule.

A copy of ``repro.analysis.index``: the two linters index a file alike.

The index is deliberately *syntactic*: it resolves what can be resolved
from imports and lexical structure (qualified call names, same-module and
cross-module function defs, ``self.method`` targets) and returns ``None``
for everything else.  Rules are written to degrade to silence on ``None``
— a project linter earns its keep by being precise on the project's own
idioms, not by approximating a type checker.
"""
from __future__ import annotations

import ast
import dataclasses
from pathlib import Path

from repro_torch.analysis.findings import Finding
from repro_torch.analysis.suppress import parse_suppressions

PARSE_RULE_ID = "parse-error"


@dataclasses.dataclass
class ModuleInfo:
    """Everything the rules need about one parsed source file."""

    path: str  # as reported in findings (relative where possible)
    abspath: Path
    module: str  # dotted module name, best-effort ('' outside a package)
    source: str
    lines: list[str]
    tree: ast.Module
    imports: dict[str, str]  # local name -> fully qualified dotted target
    functions: dict[str, ast.FunctionDef | ast.AsyncFunctionDef]  # qualname
    classes: dict[str, ast.ClassDef]  # qualname -> node
    suppressions: dict[int, frozenset[str]]
    parents: dict[ast.AST, ast.AST]  # child -> parent, whole tree

    # -- name resolution ---------------------------------------------------

    def qualify(self, node: ast.AST) -> str | None:
        """Dotted name of a Name/Attribute chain with imports resolved.

        ``tf.vmap`` (after ``import torch.func as tf``) →
        ``'torch.func.vmap'``; unresolvable shapes (calls, subscripts) →
        None.
        """
        parts: list[str] = []
        while isinstance(node, ast.Attribute):
            parts.append(node.attr)
            node = node.value
        if not isinstance(node, ast.Name):
            return None
        root = self.imports.get(node.id, node.id)
        return ".".join([root] + list(reversed(parts)))

    def enclosing_function(
        self, node: ast.AST
    ) -> ast.FunctionDef | ast.AsyncFunctionDef | None:
        cur = self.parents.get(node)
        while cur is not None:
            if isinstance(cur, (ast.FunctionDef, ast.AsyncFunctionDef)):
                return cur
            cur = self.parents.get(cur)
        return None

    def enclosing_class(self, node: ast.AST) -> ast.ClassDef | None:
        cur = self.parents.get(node)
        while cur is not None:
            if isinstance(cur, ast.ClassDef):
                return cur
            cur = self.parents.get(cur)
        return None

    def qualname_of(self, fn: ast.AST) -> str:
        """Dotted qualname of a def/class within this module (no module
        prefix): ``Class.method``, ``outer.inner``."""
        names = [getattr(fn, "name", "<anon>")]
        cur = self.parents.get(fn)
        while cur is not None:
            if isinstance(
                cur, (ast.FunctionDef, ast.AsyncFunctionDef, ast.ClassDef)
            ):
                names.append(cur.name)
            cur = self.parents.get(cur)
        return ".".join(reversed(names))

    def resolve_local(self, name: str, scope: ast.AST) -> ast.AST | None:
        """Last assignment/def binding ``name`` lexically before use.

        Searches the enclosing function body (then module body) for
        ``name = <expr>`` or ``def name``; returns the value expression or
        the FunctionDef.  Good enough for the repo's idiom of binding a
        callable, a status or an entry name right above its use.
        """
        bodies = []
        fn = scope if isinstance(
            scope, (ast.FunctionDef, ast.AsyncFunctionDef)
        ) else self.enclosing_function(scope)
        while fn is not None:
            bodies.append(fn)
            fn = self.enclosing_function(fn)
        bodies.append(self.tree)
        for holder in bodies:
            found: ast.AST | None = None
            for stmt in ast.walk(holder):
                if isinstance(stmt, ast.Assign):
                    for t in stmt.targets:
                        if isinstance(t, ast.Name) and t.id == name:
                            found = stmt.value
                elif isinstance(
                    stmt, (ast.FunctionDef, ast.AsyncFunctionDef)
                ) and stmt.name == name:
                    found = stmt
            if found is not None:
                return found
        return None


@dataclasses.dataclass
class FileIndex:
    """All parsed modules plus cross-module lookup tables."""

    modules: list[ModuleInfo]
    by_module: dict[str, ModuleInfo]
    parse_findings: list[Finding]
    pragma_findings: list[Finding]

    @classmethod
    def build(cls, paths: list[str | Path]) -> "FileIndex":
        files: list[Path] = []
        for p in paths:
            p = Path(p)
            if p.is_dir():
                files.extend(sorted(p.rglob("*.py")))
            elif p.suffix == ".py":
                files.append(p)
        modules: list[ModuleInfo] = []
        parse_findings: list[Finding] = []
        pragma_findings: list[Finding] = []
        cwd = Path.cwd()
        for f in files:
            abspath = f.resolve()
            try:
                rel = str(abspath.relative_to(cwd))
            except ValueError:
                rel = str(f)
            source = abspath.read_text(encoding="utf-8")
            try:
                tree = ast.parse(source, filename=rel)
            except SyntaxError as e:
                parse_findings.append(
                    Finding(rel, e.lineno or 1, PARSE_RULE_ID, str(e.msg))
                )
                continue
            lines = source.splitlines()
            supp, bad = parse_suppressions(rel, lines)
            pragma_findings.extend(bad)
            mod = ModuleInfo(
                path=rel,
                abspath=abspath,
                module=_module_name(abspath),
                source=source,
                lines=lines,
                tree=tree,
                imports=_collect_imports(tree),
                functions={},
                classes={},
                suppressions=supp,
                parents=_parent_map(tree),
            )
            _collect_defs(mod)
            modules.append(mod)
        return cls(
            modules=modules,
            by_module={m.module: m for m in modules if m.module},
            parse_findings=parse_findings,
            pragma_findings=pragma_findings,
        )

    def lookup_function(
        self, module: str, qualname: str
    ) -> tuple[ModuleInfo, ast.AST] | None:
        mod = self.by_module.get(module)
        if mod is None:
            return None
        fn = mod.functions.get(qualname)
        return None if fn is None else (mod, fn)


def resolve_callable(
    index: "FileIndex", mod: ModuleInfo, node: ast.AST, scope: ast.AST
) -> tuple[ModuleInfo, ast.AST] | None:
    """Best-effort: the function def an expression evaluates to.

    Handles the repo's idioms: a bare name (local def / module-level def /
    cross-module import), a lambda, ``functools.partial(f, ...)``, a local
    variable bound to one of those, and a kernel/body factory call —
    ``make_kernel(k)(...)`` resolves through the factory to the inner def
    it returns.  Anything else → None (rules stay silent).
    """
    for _ in range(8):  # bounded unwrapping: name -> assign -> call -> ...
        if node is None:
            return None
        if isinstance(node, ast.Lambda):
            return mod, node
        if isinstance(node, (ast.FunctionDef, ast.AsyncFunctionDef)):
            return mod, node
        if isinstance(node, ast.Name):
            local = mod.resolve_local(node.id, scope)
            if local is not None:
                node = local
                continue
            qual = mod.imports.get(node.id)
            if qual and "." in qual:
                target_mod, _, fn_name = qual.rpartition(".")
                hit = index.lookup_function(target_mod, fn_name)
                if hit is not None:
                    return hit
            return None
        if isinstance(node, ast.Call):
            fq = mod.qualify(node.func)
            if fq == "functools.partial" and node.args:
                node = node.args[0]
                continue
            # factory call: resolve the factory def, then the def it returns
            factory = resolve_callable(index, mod, node.func, scope)
            if factory is None:
                return None
            fmod, fdef = factory
            if not isinstance(fdef, (ast.FunctionDef, ast.AsyncFunctionDef)):
                return None
            for stmt in ast.walk(fdef):
                if isinstance(stmt, ast.Return) and isinstance(
                    stmt.value, ast.Name
                ):
                    for inner in ast.walk(fdef):
                        if (
                            isinstance(
                                inner,
                                (ast.FunctionDef, ast.AsyncFunctionDef),
                            )
                            and inner.name == stmt.value.id
                        ):
                            return fmod, inner
            return None
        return None
    return None


def _module_name(abspath: Path) -> str:
    """Dotted module path by walking up through __init__.py parents."""
    parts = [abspath.stem] if abspath.stem != "__init__" else []
    cur = abspath.parent
    while (cur / "__init__.py").exists():
        parts.append(cur.name)
        cur = cur.parent
    return ".".join(reversed(parts))


def _collect_imports(tree: ast.Module) -> dict[str, str]:
    imports: dict[str, str] = {}
    for node in ast.walk(tree):
        if isinstance(node, ast.Import):
            for alias in node.names:
                if alias.asname:
                    imports[alias.asname] = alias.name
                else:
                    top = alias.name.split(".")[0]
                    imports[top] = top
        elif isinstance(node, ast.ImportFrom) and node.module and not node.level:
            for alias in node.names:
                if alias.name == "*":
                    continue
                imports[alias.asname or alias.name] = (
                    f"{node.module}.{alias.name}"
                )
    return imports


def _parent_map(tree: ast.Module) -> dict[ast.AST, ast.AST]:
    parents: dict[ast.AST, ast.AST] = {}
    for node in ast.walk(tree):
        for child in ast.iter_child_nodes(node):
            parents[child] = node
    return parents


def _collect_defs(mod: ModuleInfo) -> None:
    for node in ast.walk(mod.tree):
        if isinstance(node, (ast.FunctionDef, ast.AsyncFunctionDef)):
            mod.functions[mod.qualname_of(node)] = node
        elif isinstance(node, ast.ClassDef):
            mod.classes[mod.qualname_of(node)] = node
