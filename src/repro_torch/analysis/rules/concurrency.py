"""Pass 3 — concurrency: lock discipline and thread lifecycle.

Port of ``repro.analysis.rules.concurrency``: the three thread rules work
as the reference's; ``kv-deadline`` is retargeted from the coordination
client's ``blocking_key_value_get*`` to the port's ``TCPStore``.

The async refresh stack (``AsyncRefresher``, ``CoresetService``,
``CoresetSampler``'s staged double buffer, the extraction ``Prefetcher``)
is the one part of the codebase where two threads share mutable state.
Its safety argument is simple and must stay simple: *every write to a
shared attribute happens under the owning lock, and every spawned thread
has a join path and a failure-propagation path*.  This pass checks those
three properties per class:

  * ``lock-discipline`` — for any class that creates a
    ``threading.Lock``/``RLock`` attribute in ``__init__``, the set of
    *shared* attributes is inferred as "assigned under ``with self._lock``
    somewhere outside ``__init__``"; any write (plain, augmented, tuple
    or ``del``) to a shared attribute outside a with-lock block — in any
    method or worker closure except ``__init__`` — is flagged.  Reads are
    deliberately exempt: CPython reference loads are atomic and the
    staged→installed double-buffer protocol tolerates stale reads by
    design (DESIGN.md §4); the race class this rule targets is
    lost/torn *updates*.
  * ``thread-join`` — every ``threading.Thread(...)`` must be bound to a
    name/attribute (no fire-and-forget ``Thread(...).start()``), and its
    enclosing class (or module) must join a thread somewhere — otherwise
    shutdown can tear down the interpreter under a live worker mid-
    launch, and nothing ever observes the worker's fate.
  * ``thread-failure-propagation`` — the thread's ``target=`` function
    must contain a try/except that *does something* with the exception
    (stores, queues or re-raises it).  A bare worker loop means a failed
    selection dies silently on the worker thread and training continues
    on stale data forever — the exact failure mode
    ``AsyncRefresher._raise_if_failed`` exists to prevent.
  * ``kv-deadline`` — a blocking ``TCPStore`` read (``.get``, ``.wait``
    or ``.multi_get`` on a receiver whose last name is ``store`` or ends
    in ``_store``) may appear only inside the designated wrappers of
    ``distributed/process_tree.py``: ``_raw_get_bytes``, which
    ``_kv_get`` calls with the configured deadline and whose failures it
    wraps in a :class:`KVStoreError` naming the key, pid and tree level,
    and ``_poll_str``, whose ``store.get`` runs only after ``store.check``
    has seen the key, so it returns at once.  A bare blocking read
    elsewhere is an unbounded, context-free hang waiting to happen.
    ``store.add``, ``store.set`` and ``store.check`` never block and are
    not flagged.
"""
from __future__ import annotations

import ast
from typing import Iterable, Iterator

from repro_torch.analysis.engine import Rule
from repro_torch.analysis.findings import Finding
from repro_torch.analysis.index import FileIndex, ModuleInfo

LOCK_RULE = "lock-discipline"
JOIN_RULE = "thread-join"
FAILURE_RULE = "thread-failure-propagation"
KV_RULE = "kv-deadline"

_LOCK_CTORS = frozenset(
    {"threading.Lock", "threading.RLock", "threading.Condition"}
)
_THREAD_CTOR = "threading.Thread"

# the only functions allowed to make a blocking TCPStore read; all other
# call sites must use the deadline/error wrapper built on them
_KV_WRAPPERS = frozenset({"_raw_get_bytes", "_poll_str"})
# TCPStore methods that block until the key exists (or the store's timeout)
_BLOCKING_STORE_METHODS = frozenset({"get", "wait", "multi_get"})


class ConcurrencyRule(Rule):
    rule_ids = (LOCK_RULE, JOIN_RULE, FAILURE_RULE, KV_RULE)
    description = (
        "shared attributes written only under the owning lock; spawned "
        "threads joined and their failures propagated; blocking TCPStore "
        "reads confined to the deadline wrapper"
    )

    def run(self, index: FileIndex) -> Iterable[Finding]:
        findings: list[Finding] = []
        for mod in index.modules:
            for cls in mod.classes.values():
                findings.extend(_check_lock_discipline(mod, cls))
            findings.extend(_check_threads(mod))
            findings.extend(_check_kv_deadline(mod))
        return findings


# ---------------------------------------------------------------------------
# lock-discipline
# ---------------------------------------------------------------------------


def _check_lock_discipline(
    mod: ModuleInfo, cls: ast.ClassDef
) -> Iterator[Finding]:
    locks = _lock_attrs(mod, cls)
    if not locks:
        return
    shared = _shared_attrs(mod, cls, locks)
    if not shared:
        return
    for meth in _methods(cls):
        if meth.name == "__init__":
            continue  # pre-publication: no second thread can exist yet
        for node in ast.walk(meth):
            for attr in _written_self_attrs(node):
                if attr in shared and not _under_lock(mod, node, locks):
                    yield Finding(
                        mod.path,
                        node.lineno,
                        LOCK_RULE,
                        f"write to shared attribute 'self.{attr}' outside "
                        f"'with self.{next(iter(locks))}' "
                        f"({cls.name}.{meth.name}); it is lock-guarded "
                        "elsewhere, so this write races the other thread",
                    )


def _lock_attrs(mod: ModuleInfo, cls: ast.ClassDef) -> frozenset[str]:
    out = set()
    for node in ast.walk(cls):
        if not isinstance(node, ast.Assign):
            continue
        if (
            isinstance(node.value, ast.Call)
            and mod.qualify(node.value.func) in _LOCK_CTORS
        ):
            for t in node.targets:
                if _is_self_attr(t):
                    out.add(t.attr)
    return frozenset(out)


def _shared_attrs(
    mod: ModuleInfo, cls: ast.ClassDef, locks: frozenset[str]
) -> frozenset[str]:
    """Attributes assigned under a with-lock block anywhere in the class."""
    out = set()
    for node in ast.walk(cls):
        if not isinstance(node, ast.With):
            continue
        if not _with_takes_lock(mod, node, locks):
            continue
        for inner in ast.walk(node):
            for attr in _written_self_attrs(inner):
                out.add(attr)
    return frozenset(out - locks)


def _methods(cls: ast.ClassDef) -> list[ast.FunctionDef]:
    return [
        n
        for n in cls.body
        if isinstance(n, (ast.FunctionDef, ast.AsyncFunctionDef))
    ]


def _is_self_attr(node: ast.AST) -> bool:
    return (
        isinstance(node, ast.Attribute)
        and isinstance(node.value, ast.Name)
        and node.value.id == "self"
    )


def _written_self_attrs(node: ast.AST) -> list[str]:
    """Attribute names this single statement writes on ``self``."""
    targets: list[ast.AST] = []
    if isinstance(node, ast.Assign):
        targets = list(node.targets)
    elif isinstance(node, (ast.AugAssign, ast.AnnAssign)):
        targets = [node.target]
    elif isinstance(node, ast.Delete):
        targets = list(node.targets)
    out = []
    for t in targets:
        if isinstance(t, (ast.Tuple, ast.List)):
            out.extend(a.attr for a in t.elts if _is_self_attr(a))
        elif _is_self_attr(t):
            out.append(t.attr)
    return out


def _with_takes_lock(
    mod: ModuleInfo, node: ast.With, locks: frozenset[str]
) -> bool:
    for item in node.items:
        expr = item.context_expr
        if _is_self_attr(expr) and expr.attr in locks:
            return True
    return False


def _under_lock(
    mod: ModuleInfo, node: ast.AST, locks: frozenset[str]
) -> bool:
    cur = mod.parents.get(node)
    while cur is not None:
        if isinstance(cur, ast.With) and _with_takes_lock(mod, cur, locks):
            return True
        cur = mod.parents.get(cur)
    return False


# ---------------------------------------------------------------------------
# thread-join / thread-failure-propagation
# ---------------------------------------------------------------------------


def _check_threads(mod: ModuleInfo) -> Iterator[Finding]:
    for node in ast.walk(mod.tree):
        if not (
            isinstance(node, ast.Call)
            and mod.qualify(node.func) == _THREAD_CTOR
        ):
            continue
        parent = mod.parents.get(node)
        if not isinstance(parent, (ast.Assign, ast.AnnAssign)):
            yield Finding(
                mod.path,
                node.lineno,
                JOIN_RULE,
                "threading.Thread is not bound to a name/attribute — "
                "nothing can ever join it or observe its fate",
            )
        else:
            scope = mod.enclosing_class(node) or mod.tree
            if not _scope_has_join(scope):
                owner = (
                    mod.enclosing_class(node).name
                    if mod.enclosing_class(node)
                    else "module"
                )
                yield Finding(
                    mod.path,
                    node.lineno,
                    JOIN_RULE,
                    f"{owner} spawns a thread but never joins one; add a "
                    "join path (wait()/close()) so shutdown and error "
                    "handling can retire the worker",
                )
        target = next(
            (kw.value for kw in node.keywords if kw.arg == "target"), None
        )
        if isinstance(target, ast.Name):
            tdef = mod.resolve_local(target.id, node)
            if isinstance(
                tdef, (ast.FunctionDef, ast.AsyncFunctionDef)
            ) and not _captures_failure(tdef):
                yield Finding(
                    mod.path,
                    tdef.lineno,
                    FAILURE_RULE,
                    f"thread target '{tdef.name}' has no try/except "
                    "capturing worker failure; an exception here dies "
                    "silently on the worker thread — store it and "
                    "re-raise on the consumer thread",
                )


def _scope_has_join(scope: ast.AST) -> bool:
    for node in ast.walk(scope):
        if (
            isinstance(node, ast.Call)
            and isinstance(node.func, ast.Attribute)
            and node.func.attr == "join"
        ):
            return True
    return False


# ---------------------------------------------------------------------------
# kv-deadline
# ---------------------------------------------------------------------------


def _check_kv_deadline(mod: ModuleInfo) -> Iterator[Finding]:
    for node in ast.walk(mod.tree):
        if not (
            isinstance(node, ast.Call)
            and isinstance(node.func, ast.Attribute)
            and node.func.attr in _BLOCKING_STORE_METHODS
            and _is_store(node.func.value)
        ):
            continue
        fn = _enclosing_function(mod, node)
        if fn is not None and fn.name in _KV_WRAPPERS:
            continue
        yield Finding(
            mod.path,
            node.lineno,
            KV_RULE,
            f"blocking store.{node.func.attr} outside the deadline wrapper "
            f"({', '.join(sorted(_KV_WRAPPERS))}); call _kv_get instead so "
            "the wait is bounded by the configured deadline and failures "
            "name the key, pid and tree level",
        )


def _is_store(receiver: ast.AST) -> bool:
    """``store``, ``x_store``, ``self._store``, ``obj.store``: the last
    name of the receiver is ``store`` or ends in ``_store``."""
    if isinstance(receiver, ast.Name):
        name = receiver.id
    elif isinstance(receiver, ast.Attribute):
        name = receiver.attr
    else:
        return False
    return name == "store" or name.endswith("_store")


def _enclosing_function(
    mod: ModuleInfo, node: ast.AST
) -> ast.FunctionDef | ast.AsyncFunctionDef | None:
    cur = mod.parents.get(node)
    while cur is not None:
        if isinstance(cur, (ast.FunctionDef, ast.AsyncFunctionDef)):
            return cur
        cur = mod.parents.get(cur)
    return None


def _captures_failure(fn: ast.AST) -> bool:
    """try/except whose handler does more than pass (stores/raises)."""
    for node in ast.walk(fn):
        if not isinstance(node, ast.Try):
            continue
        for handler in node.handlers:
            meaningful = [
                s for s in handler.body if not isinstance(s, ast.Pass)
            ]
            if meaningful:
                return True
    return False
