"""Pass 4 — API hygiene: a declarative deprecated-name / forbidden-import
table, plus the engine-registration contract.

Port of ``repro.analysis.rules.api_hygiene``: the same three rule ids,
over the port's paths.  Each table row is one invariant with its own
allowlist and rationale, so the next "this name must not escape its
module" guard is a one-line entry instead of a new test file.

Checks:
  * ``flat-engine-knob`` — the legacy flat CraigConfig knobs
    (``device_q``/``topk_k``/``device_stale_tol``) appear as identifiers
    only inside ``repro_torch/core/engines/legacy.py`` (that file keeps
    its pragmas for the reference linter, which lints all of ``src/``).
  * ``forbidden-import`` — ``jax``, ``jaxlib`` and the reference package
    ``repro`` are importable only under ``repro/``: the port stands alone
    (``tests/test_torch_isolation.py`` checks the same at run time);
    ``repro_torch.kernels._build`` and ``ctypes`` stay inside
    ``repro_torch/kernels/`` (every other module goes through the
    wrappers of ``kernels.ops``, which own the device checks and the
    launch counts — the counterpart of "Pallas stays inside
    ``repro.kernels``"); the legacy shim is imported only by its
    consumers (``core/engines/``, ``core/craig.py``,
    ``core/distributed.py``, and ``convert.py`` for the reference's impl
    names).
  * ``engine-capabilities`` — every ``SelectionEngine`` subclass under a
    ``core/engines/`` directory declares a ``capabilities =
    Capabilities(...)`` class attribute and is decorated
    ``@register_engine``: the registry's capability dispatch (and the
    host-sync pass's device-resident roots) are only sound if no engine
    bypasses registration.

Paths are matched from the top package down (``repro_torch/core/...``)
when a file lies in a package, so a checkout under a directory named
``repro`` does not open the ``repro/`` rows to the port; a file outside
any package is matched on its absolute path, as the reference matches.
"""
from __future__ import annotations

import ast
import dataclasses
from typing import Iterable, Iterator

from repro_torch.analysis.engine import Rule
from repro_torch.analysis.findings import Finding
from repro_torch.analysis.index import FileIndex, ModuleInfo

DEPRECATED_NAME_RULE = "flat-engine-knob"
FORBIDDEN_IMPORT_RULE = "forbidden-import"
ENGINE_CAPS_RULE = "engine-capabilities"


@dataclasses.dataclass(frozen=True)
class DeprecatedNames:
    """Identifiers that must not appear outside their allowlisted homes."""

    rule_id: str
    names: frozenset[str]
    allow_paths: tuple[str, ...]  # path suffixes where the names are legal
    hint: str


@dataclasses.dataclass(frozen=True)
class ForbiddenImport:
    """A module (prefix) importable only from allowlisted paths."""

    module: str
    allow_paths: tuple[str, ...]
    hint: str


# The declarative rule table.  Adding a guard == adding a row.
DEPRECATED_NAME_TABLE: tuple[DeprecatedNames, ...] = (
    DeprecatedNames(
        rule_id=DEPRECATED_NAME_RULE,
        names=frozenset({"device_q", "topk_k", "device_stale_tol"}),
        allow_paths=("repro_torch/core/engines/legacy.py",),
        hint=(
            "legacy flat engine knob; use the typed EngineConfigs from "
            "repro_torch.core.engines (the shim maps old names once, with a "
            "DeprecationWarning)"
        ),
    ),
)

_ISOLATION_HINT = (
    "the port imports neither JAX nor the reference package; it keeps its "
    "own copy of what it needs (only tests import both)"
)
_KERNELS_HINT = (
    "the ctypes bindings stay inside repro_torch.kernels — call the "
    "wrappers of kernels.ops, which own the device checks, the status "
    "check and the launch counts"
)

FORBIDDEN_IMPORT_TABLE: tuple[ForbiddenImport, ...] = (
    ForbiddenImport(module="jax", allow_paths=("repro/",), hint=_ISOLATION_HINT),
    ForbiddenImport(
        module="jaxlib", allow_paths=("repro/",), hint=_ISOLATION_HINT
    ),
    ForbiddenImport(
        module="repro", allow_paths=("repro/",), hint=_ISOLATION_HINT
    ),
    ForbiddenImport(
        module="repro_torch.kernels._build",
        allow_paths=("repro_torch/kernels/",),
        hint=_KERNELS_HINT,
    ),
    ForbiddenImport(
        module="ctypes",
        allow_paths=("repro_torch/kernels/",),
        hint=_KERNELS_HINT,
    ),
    ForbiddenImport(
        module="repro_torch.core.engines.legacy",
        allow_paths=(
            "repro_torch/core/engines/",
            "repro_torch/core/craig.py",
            "repro_torch/core/distributed.py",
            "repro_torch/convert.py",
        ),
        hint=(
            "the legacy-knob shim has three consumers (convert.py imports "
            "only IMPL_FROM_REFERENCE, which maps the reference's impl "
            "names, not flat knobs); new code takes typed EngineConfigs "
            "instead of resurrecting flat knobs"
        ),
    ),
)

_ENGINES_DIR = "core/engines/"
_ENGINE_EXEMPT = ("base.py", "registry.py", "legacy.py", "__init__.py")


class ApiHygieneRule(Rule):
    rule_ids = (
        DEPRECATED_NAME_RULE,
        FORBIDDEN_IMPORT_RULE,
        ENGINE_CAPS_RULE,
    )
    description = (
        "deprecated-name/forbidden-import table (incl. the flat-engine-"
        "knob guard) and the engine Capabilities registration contract"
    )

    def run(self, index: FileIndex) -> Iterable[Finding]:
        findings: list[Finding] = []
        for mod in index.modules:
            findings.extend(_check_deprecated_names(mod))
            findings.extend(_check_forbidden_imports(mod))
            findings.extend(_check_engine_registration(mod))
        return findings


def _allowed(mod: ModuleInfo, allow_paths: tuple[str, ...]) -> bool:
    p = _scope_path(mod)
    return any(a in p for a in allow_paths)


def _scope_path(mod: ModuleInfo) -> str:
    """The path from the top package down (``repro_torch/core/craig.py``)
    for a file inside a package; the absolute path otherwise."""
    top = mod.abspath.parent
    if not (top / "__init__.py").exists():
        return str(mod.abspath).replace("\\", "/")
    while (top.parent / "__init__.py").exists():
        top = top.parent
    return mod.abspath.relative_to(top.parent).as_posix()


# ---------------------------------------------------------------------------
# deprecated names
# ---------------------------------------------------------------------------


def _check_deprecated_names(mod: ModuleInfo) -> Iterator[Finding]:
    for row in DEPRECATED_NAME_TABLE:
        if _allowed(mod, row.allow_paths):
            continue
        for node in ast.walk(mod.tree):
            name = _identifier_of(node)
            if name in row.names:
                yield Finding(
                    mod.path,
                    getattr(node, "lineno", 1),
                    row.rule_id,
                    f"deprecated name '{name}': {row.hint}",
                )


def _identifier_of(node: ast.AST) -> str | None:
    """Identifier-position occurrences: names, attributes, keyword args,
    function parameters and annotated fields — not docstrings/comments."""
    if isinstance(node, ast.Name):
        return node.id
    if isinstance(node, ast.Attribute):
        return node.attr
    if isinstance(node, ast.keyword):
        return node.arg
    if isinstance(node, ast.arg):
        return node.arg
    if isinstance(node, (ast.FunctionDef, ast.AsyncFunctionDef, ast.ClassDef)):
        return node.name
    return None


# ---------------------------------------------------------------------------
# forbidden imports
# ---------------------------------------------------------------------------


def _check_forbidden_imports(mod: ModuleInfo) -> Iterator[Finding]:
    rows = [r for r in FORBIDDEN_IMPORT_TABLE if not _allowed(mod, r.allow_paths)]
    imports = [
        n for n in ast.walk(mod.tree) if isinstance(n, (ast.Import, ast.ImportFrom))
    ] if rows else []
    for row in rows:
        for node in imports:
            hit = None
            if isinstance(node, ast.Import):
                for alias in node.names:
                    if alias.name == row.module or alias.name.startswith(
                        row.module + "."
                    ):
                        hit = alias.name
            elif isinstance(node, ast.ImportFrom) and node.module:
                if node.module == row.module or node.module.startswith(
                    row.module + "."
                ):
                    hit = node.module
                elif any(
                    f"{node.module}.{a.name}" == row.module
                    for a in node.names
                ):
                    hit = row.module
            if hit is not None:
                yield Finding(
                    mod.path,
                    node.lineno,
                    FORBIDDEN_IMPORT_RULE,
                    f"import of '{hit}' is confined to "
                    f"{', '.join(row.allow_paths)}: {row.hint}",
                )


# ---------------------------------------------------------------------------
# engine registration contract
# ---------------------------------------------------------------------------


def _check_engine_registration(mod: ModuleInfo) -> Iterator[Finding]:
    p = _scope_path(mod)
    if _ENGINES_DIR not in p or p.endswith(_ENGINE_EXEMPT):
        return
    for cls in mod.classes.values():
        if not _subclasses_selection_engine(mod, cls):
            continue
        has_caps = any(
            isinstance(stmt, ast.Assign)
            and any(
                isinstance(t, ast.Name) and t.id == "capabilities"
                for t in stmt.targets
            )
            for stmt in cls.body
        )
        registered = any(
            (mod.qualify(dec) or "").endswith("register_engine")
            for dec in cls.decorator_list
        )
        if not has_caps:
            yield Finding(
                mod.path,
                cls.lineno,
                ENGINE_CAPS_RULE,
                f"engine {cls.name} declares no 'capabilities = "
                "Capabilities(...)'; the registry's capability dispatch "
                "(and the host-sync pass) need it",
            )
        if not registered:
            yield Finding(
                mod.path,
                cls.lineno,
                ENGINE_CAPS_RULE,
                f"engine {cls.name} is not decorated @register_engine; "
                "unregistered engines bypass capability gating and "
                "engine='auto'",
            )


def _subclasses_selection_engine(mod: ModuleInfo, cls: ast.ClassDef) -> bool:
    return any(
        (mod.qualify(b) or "").rpartition(".")[2] == "SelectionEngine"
        for b in cls.bases
    )
