"""Pass 1 — host syncs: no host round trips on traced or device-resident
paths.

Stands where the reference has ``jit_safety`` (``jit-host-sync``).  The
port's greedy loops are Python loops over device tensors, so a stray
``.item()`` or a Python ``if`` on a tensor does not break a trace: it
blocks the host on the card once a round, and the engine's advantage over
a host loop quietly evaporates.  This pass finds such syncs statically.

Roots, of two kinds:
  * (a) callables handed to a torch tracing transform — ``torch.func.vmap``
    / ``torch.vmap``, ``torch.func.grad``, ``grad_and_value``, ``jacrev``,
    ``jacfwd``, ``torch.compile``, ``torch.cuda.make_graphed_callables`` —
    defs decorated with one of them, and the body of ``with
    torch.cuda.graph(...)``.  A sync anywhere reachable from these breaks
    the trace or the capture, so every one is flagged.
  * (b) ``select`` of every engine whose ``capabilities =
    Capabilities(...)`` sets ``device_resident=True``: the contract that
    only the small outputs cross to the host.  Here a sync is flagged only
    where it runs once a round: inside a ``for``/``while`` body (or a
    ``while`` test, or a comprehension) of a reachable function, or
    anywhere in a function reached through a call made inside such a
    loop.  One sync outside every loop is the contract's "small outputs
    cross to the host".  (``select_cover`` is exempt, as in the
    reference: cover mode is data-dependently sized and host-side.)

From the roots the pass walks the project call graph exactly as the
reference does (same-module calls, ``self.method``, and calls into
``repro_torch.*`` resolved through imports) and flags:

  * ``.item()`` / ``.tolist()`` / ``.cpu()`` / ``.numpy()``, and
    ``.to("cpu")`` / ``.to(device="cpu")`` — a device->host copy;
  * ``torch.cuda.synchronize()``;
  * ``np.asarray`` / ``np.array`` of an expression — host materialization;
  * ``float()``/``int()``/``bool()`` of a tensor-valued expression — one
    containing a ``torch.*`` call, a tensor-reduction method (``sum``,
    ``max``, ``min``, ``any``, ``all``, ``argmax``, ``amax``) or a local
    name bound to such an expression in the same function;
  * ``if``/``while``/``assert``/ternary tests on a tensor-valued
    expression — Python control flow on a device value.

Python scalars are not syncs: ``int(budget)``, ``len(x)``, ``x.shape[0]``,
``x.numel()`` and the like stop the tensor-valued test, as do torch calls
that return host objects (``torch.device``, ``torch.cuda.is_available``,
``torch.finfo`` …).
"""
from __future__ import annotations

import ast
from typing import Iterable, Iterator

from repro_torch.analysis.engine import Rule
from repro_torch.analysis.findings import Finding
from repro_torch.analysis.index import FileIndex, ModuleInfo, resolve_callable

RULE_ID = "host-sync"

# Call sites whose function-valued arguments are traced or captured.
_TRACING_CALLERS = frozenset(
    {
        "torch.func.vmap",
        "torch.vmap",
        "torch.func.grad",
        "torch.func.grad_and_value",
        "torch.func.jacrev",
        "torch.func.jacfwd",
        "torch.compile",
        "torch.cuda.make_graphed_callables",
    }
)
_GRAPH_CAPTURE = "torch.cuda.graph"

# torch.* calls that return host objects, not device tensors.
_STATIC_TORCH_CALLS = frozenset(
    {
        "torch.device",
        "torch.Size",
        "torch.finfo",
        "torch.iinfo",
        "torch.dtype",
        "torch.Generator",
        "torch.promote_types",
        "torch.no_grad",
        "torch.enable_grad",
        "torch.inference_mode",
    }
)
_STATIC_TORCH_PREFIXES = (
    "torch.cuda.",
    "torch.backends.",
    "torch.distributed.",
    "torch.utils.",
    "torch.compiler.",
    "torch.jit.",
    "torch.library.",
    "torch.testing.",
    "torch.get_",
    "torch.set_",
    "torch.is_",
)

# Methods that reduce a tensor — ``bool(x.any())`` style.
_REDUCTION_METHODS = frozenset(
    {"sum", "max", "min", "any", "all", "argmax", "amax"}
)

# Sub-expressions that yield Python values even on a tensor receiver: the
# tensor-valued test does not look inside them.
_HOST_ATTRS = frozenset(
    {"shape", "dtype", "device", "ndim", "layout", "is_cuda", "requires_grad"}
)
_HOST_METHODS_OF_TENSOR = frozenset(
    {"size", "numel", "dim", "data_ptr", "stride", "element_size",
     "is_contiguous", "get_device", "nelement"}
)
_HOST_BUILTINS = frozenset(
    {"len", "isinstance", "type", "str", "repr", "hasattr", "callable",
     "id", "bool", "int", "float"}
)

_COPY_METHODS = frozenset({"item", "tolist", "cpu", "numpy"})
_HOST_CALLS = {
    "torch.cuda.synchronize": "torch.cuda.synchronize() waits for the card",
    "numpy.asarray": "np.asarray copies a device value to the host",
    "numpy.array": "np.array copies a device value to the host",
}
_LOOPS = (ast.For, ast.AsyncFor, ast.While)
_COMPREHENSIONS = (ast.ListComp, ast.SetComp, ast.DictComp, ast.GeneratorExp)
_DEFS = (ast.FunctionDef, ast.AsyncFunctionDef, ast.Lambda)


class HostSyncRule(Rule):
    rule_ids = (RULE_ID,)
    description = (
        "host syncs (.item/.cpu/.numpy, np.asarray, scalar coercion, Python "
        "branching on tensors, cuda.synchronize) reachable from torch "
        "tracing roots, or once a round in the loops of device_resident "
        "engines' select paths"
    )

    def run(self, index: FileIndex) -> Iterable[Finding]:
        findings: list[Finding] = []
        seen: set[tuple[str, int]] = set()
        for mod, fn, why, strict in _reachable(index, _collect_roots(index)):
            for f in _scan_function(mod, fn, why, strict):
                if (f.path, f.line) not in seen:
                    seen.add((f.path, f.line))
                    findings.append(f)
        return findings


# ---------------------------------------------------------------------------
# Roots
# ---------------------------------------------------------------------------

# (module, def / lambda / with-block, why, strict): strict roots flag every
# sync; the others only those that run once a loop iteration.
Root = tuple[ModuleInfo, ast.AST, str, bool]


def _collect_roots(index: FileIndex) -> list[Root]:
    roots: list[Root] = []
    for mod in index.modules:
        # (a) defs decorated with a tracing transform
        for fn in mod.functions.values():
            for dec in fn.decorator_list:
                fq = _decorator_name(mod, dec)
                if fq in _TRACING_CALLERS:
                    roots.append(
                        (mod, fn, f"@{fq} {mod.qualname_of(fn)}", True)
                    )
                    break
        for node in ast.walk(mod.tree):
            # (a) callees of tracing transforms
            if isinstance(node, ast.Call):
                fq = mod.qualify(node.func)
                if fq not in _TRACING_CALLERS:
                    continue
                for arg in list(node.args) + [kw.value for kw in node.keywords]:
                    if isinstance(arg, (ast.Name, ast.Lambda, ast.Call)):
                        hit = resolve_callable(index, mod, arg, node)
                        if hit is not None:
                            roots.append(
                                (hit[0], hit[1],
                                 f"callee of {fq.split('.')[-1]}", True)
                            )
            # (a) the body of a CUDA graph capture
            elif isinstance(node, (ast.With, ast.AsyncWith)) and any(
                isinstance(item.context_expr, ast.Call)
                and mod.qualify(item.context_expr.func) == _GRAPH_CAPTURE
                for item in node.items
            ):
                roots.append((mod, node, "torch.cuda.graph capture", True))
        # (b) select() of device_resident=True engines
        for cls in mod.classes.values():
            if not _declares_device_resident(mod, cls):
                continue
            for stmt in cls.body:
                if (
                    isinstance(stmt, (ast.FunctionDef, ast.AsyncFunctionDef))
                    and stmt.name == "select"
                ):
                    roots.append(
                        (mod, stmt,
                         f"{cls.name}.select (device_resident=True)", False)
                    )
    return roots


def _decorator_name(mod: ModuleInfo, dec: ast.AST) -> str | None:
    if isinstance(dec, ast.Call):
        fq = mod.qualify(dec.func)
        if fq == "functools.partial" and dec.args:
            return mod.qualify(dec.args[0])
        return fq
    return mod.qualify(dec)


def _declares_device_resident(mod: ModuleInfo, cls: ast.ClassDef) -> bool:
    for stmt in cls.body:
        if not isinstance(stmt, ast.Assign):
            continue
        if not any(
            isinstance(t, ast.Name) and t.id == "capabilities"
            for t in stmt.targets
        ):
            continue
        call = stmt.value
        if not isinstance(call, ast.Call):
            continue
        fq = mod.qualify(call.func) or ""
        if not fq.endswith("Capabilities"):
            continue
        for kw in call.keywords:
            if kw.arg == "device_resident" and isinstance(kw.value, ast.Constant):
                return bool(kw.value.value)
    return False


# ---------------------------------------------------------------------------
# Reachability
# ---------------------------------------------------------------------------


def _reachable(index: FileIndex, roots: list[Root]) -> list[Root]:
    """Every function reachable from the roots, once each, with its
    strictness: a function is strict when reached from a strict root, or
    through a call made inside a loop (it then runs once an iteration)."""
    found: dict[tuple[str, int, int], Root] = {}
    stack = list(roots)
    while stack:
        mod, fn, why, strict = stack.pop()
        key = (mod.path, fn.lineno, fn.col_offset)
        if key in found and (found[key][3] or not strict):
            continue
        found[key] = (mod, fn, why, strict)
        for cmod, callee, cname, call in _callees(index, mod, fn):
            stack.append(
                (cmod, callee, f"{why} -> {cname}",
                 strict or _in_loop(mod, call, fn))
            )
    return list(found.values())


def _callees(
    index: FileIndex, mod: ModuleInfo, fn: ast.AST
) -> Iterator[tuple[ModuleInfo, ast.AST, str, ast.Call]]:
    """Project-internal functions ``fn``'s body may call, with the call."""
    encl_class = mod.enclosing_class(fn)
    for node in _walk_body(fn):
        if not isinstance(node, ast.Call):
            continue
        func = node.func
        # self.method() / cls.method()
        if (
            isinstance(func, ast.Attribute)
            and isinstance(func.value, ast.Name)
            and func.value.id in ("self", "cls")
            and encl_class is not None
        ):
            target = mod.functions.get(f"{encl_class.name}.{func.attr}")
            if target is not None:
                yield mod, target, func.attr, node
            continue
        if isinstance(func, ast.Name):
            hit = resolve_callable(index, mod, func, node)
            if hit is not None:
                yield hit[0], hit[1], func.id, node
            continue
        fq = mod.qualify(func)
        if fq is None or not fq.startswith("repro_torch."):
            continue
        target_mod, _, fn_name = fq.rpartition(".")
        hit = index.lookup_function(target_mod, fn_name)
        if hit is not None:
            yield hit[0], hit[1], fn_name, node


def _walk_body(fn: ast.AST) -> Iterator[ast.AST]:
    """The nodes of a def (all of it, as the reference walks) or of a
    ``with`` block (its body only: the context expression runs once)."""
    if isinstance(fn, (ast.With, ast.AsyncWith)):
        for stmt in fn.body:
            yield from ast.walk(stmt)
    else:
        yield from ast.walk(fn)


def _in_loop(mod: ModuleInfo, node: ast.AST, fn: ast.AST) -> bool:
    """Does ``node`` run once an iteration of a loop inside ``fn``: in a
    ``for``/``while`` body or a ``while`` test, or in a comprehension's
    element, condition or inner iterables?  Nested defs end the search."""
    child, cur = node, mod.parents.get(node)
    while cur is not None and cur is not fn:
        if isinstance(cur, _DEFS):
            return False
        if isinstance(cur, _LOOPS) and (
            child in cur.body or (isinstance(cur, ast.While) and child is cur.test)
        ):
            return True
        if isinstance(cur, ast.comprehension):
            # the first generator's iterable runs once; all else once an item
            if child is not cur.iter or cur is not mod.parents[cur].generators[0]:
                return True
        elif isinstance(cur, _COMPREHENSIONS) and not isinstance(
            child, ast.comprehension
        ):
            return True
        child, cur = cur, mod.parents.get(cur)
    return False


# ---------------------------------------------------------------------------
# Violation scan
# ---------------------------------------------------------------------------


def _scan_function(
    mod: ModuleInfo, fn: ast.AST, why: str, strict: bool
) -> Iterator[Finding]:
    if strict:
        ctx = f" [traced: {why}]"
    else:
        ctx = f" [once a round: inside a loop reachable from {why}]"
    tensors = _tensor_names(mod, fn)
    for node in _walk_body(fn):
        msg, line = _sync_at(mod, node, tensors)
        if msg is None:
            continue
        if strict or _in_loop(mod, node, fn):
            yield Finding(mod.path, line, RULE_ID, msg + ctx)


def _sync_at(
    mod: ModuleInfo, node: ast.AST, tensors: frozenset[str]
) -> tuple[str | None, int]:
    """(message, line) when ``node`` forces a host sync, else (None, 0)."""
    if isinstance(node, ast.Call):
        func = node.func
        if isinstance(func, ast.Attribute):
            if func.attr in _COPY_METHODS and not node.args:
                return (
                    f".{func.attr}() blocks on a device->host copy",
                    node.lineno,
                )
            if func.attr == "to" and _to_cpu(mod, node):
                return (".to('cpu') blocks on a device->host copy", node.lineno)
        fq = mod.qualify(func)
        if fq in _HOST_CALLS and (node.args or fq == "torch.cuda.synchronize"):
            return _HOST_CALLS[fq], node.lineno
        if (
            isinstance(func, ast.Name)
            and func.id in ("float", "int", "bool")
            and func.id not in mod.imports
            and node.args
            and any(_tensor_valued(mod, a, tensors) for a in node.args)
        ):
            return (
                f"{func.id}() of a device tensor copies it to the host; "
                "keep it a tensor (torch.where, index_select)",
                node.lineno,
            )
    elif isinstance(node, (ast.If, ast.While, ast.IfExp)):
        if _tensor_valued(mod, node.test, tensors):
            return (
                "Python control flow on a device tensor copies it to the "
                "host; use torch.where or keep the branch on the host value",
                node.test.lineno,
            )
    elif isinstance(node, ast.Assert):
        if _tensor_valued(mod, node.test, tensors):
            return (
                "assert on a device tensor copies it to the host",
                node.lineno,
            )
    return None, 0


def _to_cpu(mod: ModuleInfo, call: ast.Call) -> bool:
    values = list(call.args[:1]) + [
        kw.value for kw in call.keywords if kw.arg == "device"
    ]
    for v in values:
        if isinstance(v, ast.Constant) and v.value == "cpu":
            return True
        if (
            isinstance(v, ast.Call)
            and mod.qualify(v.func) == "torch.device"
            and v.args
            and isinstance(v.args[0], ast.Constant)
            and v.args[0].value == "cpu"
        ):
            return True
    return False


def _tensor_valued(
    mod: ModuleInfo, expr: ast.AST, tensors: frozenset[str]
) -> bool:
    """Does ``expr`` contain a torch call, a tensor reduction, or a local
    name bound to one, outside the sub-expressions that yield Python
    values (``x.shape``, ``len(x)``, ``x.numel()``, ``int(...)`` …)?"""
    stack = [expr]
    while stack:
        node = stack.pop()
        if isinstance(node, ast.Attribute) and node.attr in _HOST_ATTRS:
            continue
        if isinstance(node, _DEFS):
            continue
        if isinstance(node, ast.Compare) and all(
            isinstance(op, (ast.Is, ast.IsNot)) for op in node.ops
        ):
            continue  # identity: no value is read
        if isinstance(node, ast.Call):
            func = node.func
            if isinstance(func, ast.Name) and func.id in _HOST_BUILTINS:
                continue
            if (
                isinstance(func, ast.Attribute)
                and func.attr in _HOST_METHODS_OF_TENSOR
            ):
                continue
            fq = mod.qualify(func)
            if fq is not None and fq.startswith("torch."):
                if fq in _STATIC_TORCH_CALLS or fq.startswith(
                    _STATIC_TORCH_PREFIXES
                ):
                    continue
                return True
            if (
                isinstance(func, ast.Attribute)
                and func.attr in _REDUCTION_METHODS
                and not _is_module_call(mod, func)
            ):
                return True
        if isinstance(node, ast.Name) and node.id in tensors:
            return True
        stack.extend(ast.iter_child_nodes(node))
    return False


def _tensor_names(mod: ModuleInfo, fn: ast.AST) -> frozenset[str]:
    """Local names bound to tensor-valued expressions anywhere in the
    outermost def around ``fn`` (closures read their parent's names):
    assignments, augmented assignments, walrus and ``for`` targets, to a
    fixed point."""
    top = fn
    while True:
        outer = mod.enclosing_function(top)
        if outer is None:
            break
        top = outer
    binds: list[tuple[list[str], ast.AST]] = []
    for node in ast.walk(top):
        if isinstance(node, ast.Assign):
            names = [n for t in node.targets for n in _target_names(t)]
            binds.append((names, node.value))
        elif isinstance(node, (ast.AugAssign, ast.AnnAssign)) and node.value:
            binds.append((_target_names(node.target), node.value))
        elif isinstance(node, ast.NamedExpr):
            binds.append((_target_names(node.target), node.value))
        elif isinstance(node, (ast.For, ast.AsyncFor, ast.comprehension)):
            binds.append((_target_names(node.target), node.iter))
    tensors: set[str] = set()
    changed = True
    while changed:
        changed = False
        frozen = frozenset(tensors)
        for names, value in binds:
            new = [n for n in names if n not in tensors]
            if new and _tensor_valued(mod, value, frozen):
                tensors.update(new)
                changed = True
    return frozenset(tensors)


def _target_names(target: ast.AST) -> list[str]:
    if isinstance(target, ast.Name):
        return [target.id]
    if isinstance(target, (ast.Tuple, ast.List)):
        return [n for e in target.elts for n in _target_names(e)]
    if isinstance(target, ast.Starred):
        return _target_names(target.value)
    return []


def _is_module_call(mod: ModuleInfo, func: ast.Attribute) -> bool:
    """True when the attribute chain's root name is an import — then the
    qualified-prefix test is authoritative and the reduction-method
    heuristic must not fire (``np.max`` on host arrays is host math)."""
    node: ast.AST = func
    while isinstance(node, ast.Attribute):
        node = node.value
    return isinstance(node, ast.Name) and node.id in mod.imports
