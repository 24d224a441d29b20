"""Pass 2 — CUDA wrapper contract: every ctypes binding of a hand-written
kernel self-consistent.

Stands where the reference has ``pallas_contract``.  The port binds its
kernels through ``ctypes``: ``kernels/_build.py`` declares each C entry's
argument types in ``SIGNATURES`` and counts launches per kernel in
``LAUNCHES``, and the wrappers beside it call the entries.  None of the
failures this pass looks for raises at run time: a ``SIGNATURES`` tuple
that disagrees with its ``extern "C"`` prototype, or a call with the wrong
argument count, is undefined behaviour; a wrapper that stops bumping
``LAUNCHES`` hides a lost kernel from the launch counts that
``chip_smoke.py`` holds; a handler that falls back to the plain twin turns
a broken kernel into a slow, silent success.  The pass reads
``_build.py``'s ``SIGNATURES`` and ``LAUNCHES`` dict literals and the
``extern "C" { … }`` blocks of ``csrc/<name>.cu`` beside it (comments
stripped, top-level definitions, parameters split on commas), and checks:

  * ``cuda-entry-signature`` (the counterpart of ``pallas-kernel-arity``)
    — each ``SIGNATURES[name][entry]`` has a definition in
    ``csrc/<name>.cu``'s ``extern "C"`` block with as many parameters,
    each of the same kind (a pointer for ``c_void_p``, ``int`` for
    ``c_int``); every exported definition has a ``SIGNATURES`` row;
  * ``cuda-call-arity`` — each call of an entry in the modules beside
    ``_build.py`` (``lib.<entry>(…)``, ``getattr(lib, "<entry>")(…)``, or
    ``getattr(lib, X)(…)`` with X looked up in a module-level dict
    literal) passes as many positional arguments as ``SIGNATURES``
    declares;
  * ``cuda-launch-count`` — a function that calls a *launching* entry
    (one whose last C parameter is the stream, ``void* stream``; the
    block-width, occupancy, route and cluster queries are not) passes the
    returned status to ``_build.check`` and bumps ``LAUNCHES["<key>"] +=
    1`` with ``<key>`` a literal key of ``_build.LAUNCHES``; no function
    that launches nothing bumps ``LAUNCHES``;
  * ``cuda-no-fallback`` — no ``try`` whose body calls a ``*_cuda``
    wrapper or a library entry has a handler that does not end in
    ``raise``, and no handler anywhere calls a ``*_torch`` plain twin;
  * ``cuda-accumulator-dtype`` (the counterpart of
    ``pallas-accumulator-dtype``) — no ``torch.empty``/``zeros``/``full``
    (or ``ones``, the ``*_like`` and ``new_*`` forms) with a bf16 or fp16
    dtype in a function that launches: outputs and accumulators stay fp32
    or integer, whatever the tiles;
  * ``triton-dot-precision`` (the counterpart of
    ``pallas-dot-preferred-type``) — every ``tl.dot`` inside an
    ``@triton.jit`` body passes ``input_precision="ieee"``: TF32 products
    break index parity with the reference.

Shapes the pass cannot read (a ``SIGNATURES`` row that is not a literal
tuple of ctypes names) are findings, not guesses.
"""
from __future__ import annotations

import ast
import dataclasses
import re
from pathlib import Path
from typing import Iterable, Iterator

from repro_torch.analysis.engine import Rule
from repro_torch.analysis.findings import Finding
from repro_torch.analysis.index import FileIndex, ModuleInfo

SIGNATURE_RULE = "cuda-entry-signature"
CALL_ARITY_RULE = "cuda-call-arity"
LAUNCH_COUNT_RULE = "cuda-launch-count"
NO_FALLBACK_RULE = "cuda-no-fallback"
ACCUM_DTYPE_RULE = "cuda-accumulator-dtype"
TRITON_DOT_RULE = "triton-dot-precision"

# ctypes argument type -> the kind of C parameter it must meet
_CTYPES_KIND = {
    "c_void_p": "pointer",
    "c_int": "int",
    "c_int64": "int64",
    "c_float": "float",
    "c_double": "double",
}
# C scalar parameter type -> kind (a pointer is any parameter with a '*')
_C_SCALAR_KIND = {
    "int": "int",
    "int64_t": "int64",
    "long long": "int64",
    "float": "float",
    "double": "double",
}
_LOW_PRECISION = frozenset({"bfloat16", "float16", "half"})
_ALLOC_FUNCS = frozenset(
    {"empty", "zeros", "full", "ones", "empty_like", "zeros_like",
     "full_like", "ones_like"}
)
_ALLOC_METHODS = frozenset({"new_empty", "new_zeros", "new_full", "new_ones"})


class CudaContractRule(Rule):
    rule_ids = (
        SIGNATURE_RULE,
        CALL_ARITY_RULE,
        LAUNCH_COUNT_RULE,
        NO_FALLBACK_RULE,
        ACCUM_DTYPE_RULE,
        TRITON_DOT_RULE,
    )
    description = (
        "ctypes kernel bindings: SIGNATURES vs the extern \"C\" prototypes, "
        "call arity, status check and LAUNCHES bump on every launch, no "
        "fallback to plain twins, fp32 outputs, IEEE tl.dot"
    )

    def run(self, index: FileIndex) -> Iterable[Finding]:
        findings: list[Finding] = []
        contracts = read_contracts(index)
        for contract in contracts:
            findings.extend(contract.findings)
            for mod in contract.wrappers:
                findings.extend(_check_wrappers(contract, mod))
        for mod in index.modules:
            findings.extend(_check_fallbacks(mod, contracts))
            findings.extend(_check_stray_bumps(mod, contracts))
            findings.extend(_check_triton_dots(mod))
        return findings


# ---------------------------------------------------------------------------
# The contract: _build.py's tables and the extern "C" prototypes
# ---------------------------------------------------------------------------


@dataclasses.dataclass(frozen=True)
class Prototype:
    """One top-level definition of an ``extern "C"`` block."""

    name: str
    path: str
    line: int
    params: tuple[str, ...]  # kinds: 'pointer', 'int', ... or the C text
    launches: bool  # the last parameter is the stream: it launches a kernel


@dataclasses.dataclass
class Contract:
    """What one ``kernels/_build.py`` and its ``csrc/`` declare."""

    signatures: dict[str, tuple[str, ...]]  # entry -> ctypes kinds
    launch_keys: tuple[str, ...]  # the literal keys of LAUNCHES
    prototypes: dict[str, Prototype]  # entry -> its C definition
    wrappers: list[ModuleInfo]  # the modules beside _build.py
    findings: list[Finding]

    @property
    def launching(self) -> frozenset[str]:
        """Entries whose C definition takes the stream last."""
        return frozenset(
            e for e in self.signatures
            if e in self.prototypes and self.prototypes[e].launches
        )

    def bumped_keys(self) -> dict[str, set[str]]:
        """``LAUNCHES`` keys bumped by each launching wrapper, by qualname."""
        out: dict[str, set[str]] = {}
        for mod in self.wrappers:
            for fn, calls in _entry_calls_by_function(self, mod).items():
                if any(e in self.launching for _, es in calls for e in es):
                    keys = {k for k, _ in _launch_bumps(fn)}
                    out[f"{mod.module}.{mod.qualname_of(fn)}"] = keys
        return out


def read_contracts(index: FileIndex) -> list[Contract]:
    """One :class:`Contract` for every ``_build.py`` in the index that
    assigns a ``SIGNATURES`` dict literal."""
    out = []
    for mod in index.modules:
        if mod.abspath.name != "_build.py":
            continue
        sig_node = _module_dict(mod, "SIGNATURES")
        if sig_node is None:
            continue
        out.append(_read_contract(index, mod, sig_node))
    return out


def _read_contract(
    index: FileIndex, build: ModuleInfo, sig_node: ast.Dict
) -> Contract:
    findings: list[Finding] = []
    signatures: dict[str, tuple[str, ...]] = {}
    entry_lines: dict[str, int] = {}
    sources: dict[str, int] = {}
    by_source: dict[str, list[str]] = {}
    for skey, sval in zip(sig_node.keys, sig_node.values):
        if not (isinstance(skey, ast.Constant) and isinstance(skey.value, str)):
            continue
        sources[skey.value] = skey.lineno
        by_source[skey.value] = []
        if not isinstance(sval, ast.Dict):
            findings.append(Finding(
                build.path, skey.lineno, SIGNATURE_RULE,
                f"SIGNATURES['{skey.value}'] is not a dict literal of entries",
            ))
            continue
        for ekey, eval_ in zip(sval.keys, sval.values):
            if not (
                isinstance(ekey, ast.Constant) and isinstance(ekey.value, str)
            ):
                continue
            entry_lines[ekey.value] = ekey.lineno
            by_source[skey.value].append(ekey.value)
            kinds = _ctypes_tuple(build, eval_)
            if kinds is None:
                findings.append(Finding(
                    build.path, ekey.lineno, SIGNATURE_RULE,
                    f"SIGNATURES row '{ekey.value}' is not a literal tuple of "
                    "ctypes types (sums and products of tuples of _P/_I "
                    "names) the pass can read",
                ))
                continue
            signatures[ekey.value] = kinds

    launches = _module_dict(build, "LAUNCHES")
    launch_keys = tuple(
        k.value for k in (launches.keys if launches is not None else ())
        if isinstance(k, ast.Constant) and isinstance(k.value, str)
    )

    csrc = build.abspath.parent / "csrc"
    prototypes: dict[str, Prototype] = {}
    for name, line in sources.items():
        cu = csrc / f"{name}.cu"
        if not cu.exists():
            findings.append(Finding(
                build.path, line, SIGNATURE_RULE,
                f"SIGNATURES names source '{name}' but {_rel(cu)} does not "
                "exist",
            ))
            continue
        for proto in parse_extern_c(cu):
            prototypes[proto.name] = proto
    for cu in sorted(csrc.glob("*.cu")) if csrc.is_dir() else ():
        declared = set(by_source.get(cu.stem, ()))
        for proto in parse_extern_c(cu):
            if proto.name not in declared:
                findings.append(Finding(
                    proto.path, proto.line, SIGNATURE_RULE,
                    f"exported '{proto.name}' has no SIGNATURES['{cu.stem}'] "
                    "row: ctypes would call it with no argument types",
                ))
    for name, entries in by_source.items():
        for entry in entries:
            findings.extend(
                _check_entry(build, name, entry, entry_lines[entry],
                             signatures.get(entry), prototypes)
            )
    wrappers = [
        m for m in index.modules
        if m.abspath.parent == build.abspath.parent and m is not build
    ]
    return Contract(signatures, launch_keys, prototypes, wrappers, findings)


def _check_entry(
    build: ModuleInfo, source: str, entry: str, line: int,
    kinds: tuple[str, ...] | None, prototypes: dict[str, Prototype],
) -> Iterator[Finding]:
    proto = prototypes.get(entry)
    if proto is None or Path(proto.path).stem != source:
        yield Finding(
            build.path, line, SIGNATURE_RULE,
            f"SIGNATURES['{source}']['{entry}'] has no definition in the "
            f"extern \"C\" block of csrc/{source}.cu",
        )
        return
    if kinds is None:
        return
    if len(kinds) != len(proto.params):
        yield Finding(
            build.path, line, SIGNATURE_RULE,
            f"'{entry}' declares {len(kinds)} argument(s) but "
            f"{proto.path}:{proto.line} takes {len(proto.params)}",
        )
        return
    for i, (want, got) in enumerate(zip(kinds, proto.params)):
        if want != got:
            yield Finding(
                build.path, line, SIGNATURE_RULE,
                f"'{entry}' argument {i} is declared {want} but "
                f"{proto.path}:{proto.line} takes {got}",
            )


def _ctypes_tuple(mod: ModuleInfo, node: ast.AST) -> tuple[str, ...] | None:
    """Evaluate ``(_P,) * 6 + (_I,) * 3 + (_P,)``-style tuple expressions
    into parameter kinds; None for anything else."""
    if isinstance(node, ast.Tuple):
        out = []
        for elt in node.elts:
            kind = _ctypes_kind(mod, elt)
            if kind is None:
                return None
            out.append(kind)
        return tuple(out)
    if isinstance(node, ast.BinOp) and isinstance(node.op, ast.Add):
        left = _ctypes_tuple(mod, node.left)
        right = _ctypes_tuple(mod, node.right)
        return None if left is None or right is None else left + right
    if isinstance(node, ast.BinOp) and isinstance(node.op, ast.Mult):
        for seq, times in ((node.left, node.right), (node.right, node.left)):
            if isinstance(times, ast.Constant) and isinstance(times.value, int):
                inner = _ctypes_tuple(mod, seq)
                return None if inner is None else inner * times.value
    return None


def _ctypes_kind(mod: ModuleInfo, node: ast.AST) -> str | None:
    if isinstance(node, ast.Name):
        bound = _module_value(mod, node.id)
        if bound is not None:
            node = bound
    fq = mod.qualify(node) or ""
    root, _, name = fq.rpartition(".")
    return _CTYPES_KIND.get(name) if root == "ctypes" else None


def _module_value(mod: ModuleInfo, name: str) -> ast.AST | None:
    """The value of the last module-level ``name = ...`` (or annotated)."""
    found = None
    for stmt in mod.tree.body:
        if isinstance(stmt, ast.Assign) and any(
            isinstance(t, ast.Name) and t.id == name for t in stmt.targets
        ):
            found = stmt.value
        elif (
            isinstance(stmt, ast.AnnAssign)
            and isinstance(stmt.target, ast.Name)
            and stmt.target.id == name
            and stmt.value is not None
        ):
            found = stmt.value
    return found


def _module_dict(mod: ModuleInfo, name: str) -> ast.Dict | None:
    value = _module_value(mod, name)
    return value if isinstance(value, ast.Dict) else None


def _rel(path: Path) -> str:
    try:
        return str(path.resolve().relative_to(Path.cwd()))
    except ValueError:
        return str(path)


# -- extern "C" parsing -------------------------------------------------------

_COMMENT_OR_STRING = re.compile(
    r'//[^\n]*|/\*.*?\*/|"(?:\\.|[^"\\\n])*"|\'(?:\\.|[^\'\\\n])*\'',
    re.DOTALL,
)
_EXTERN_C = re.compile(r'extern\s+"C"\s*\{')
_HEADER = re.compile(
    r"(?P<ret>[\w\s\*&:<>,]*?)\b(?P<name>[A-Za-z_]\w*)\s*"
    r"\((?P<params>[^()]*)\)\s*(?:noexcept\s*)?$",
    re.DOTALL,
)


def _strip_comments(text: str) -> str:
    """Comments become spaces (newlines kept, so lines still count);
    string literals stay."""
    def repl(m: re.Match) -> str:
        s = m.group(0)
        if s.startswith(("//", "/*")):
            return re.sub(r"[^\n]", " ", s)
        return s
    return _COMMENT_OR_STRING.sub(repl, text)


def parse_extern_c(cu: Path) -> list[Prototype]:
    """Top-level function definitions of every ``extern "C" { … }`` block
    of ``cu``, with their parameter kinds and 1-based lines."""
    text = _strip_comments(cu.read_text(encoding="utf-8"))
    path = _rel(cu)
    out: list[Prototype] = []
    for m in _EXTERN_C.finditer(text):
        depth, start, i = 0, m.end(), m.end()
        while i < len(text):
            c = text[i]
            if c == "}" and depth == 0:
                break  # the block's own closing brace
            if c in ";}" and depth == 0:
                start = i + 1
            elif c == "{":
                if depth == 0:
                    proto = _prototype(text, start, i, path)
                    if proto is not None:
                        out.append(proto)
                depth += 1
            elif c == "}":
                depth -= 1
                if depth == 0:
                    start = i + 1
            i += 1
    return out


def _prototype(text: str, start: int, brace: int, path: str) -> Prototype | None:
    header = text[start:brace].strip()
    hm = _HEADER.search(header)
    if hm is None or not hm.group("ret").strip():
        return None
    if re.search(r"\bstatic\b", hm.group("ret")):
        return None  # not exported
    offset = start + (len(text[start:brace]) - len(text[start:brace].lstrip()))
    name_at = offset + hm.start("name")
    line = text.count("\n", 0, name_at) + 1
    raw = [p.strip() for p in hm.group("params").split(",")]
    if raw == [""] or raw == ["void"]:
        raw = []
    params = tuple(_param_kind(p) for p in raw)
    stream = bool(raw) and params[-1] == "pointer" and (
        re.search(r"\bstream$", raw[-1]) is not None
    )
    return Prototype(hm.group("name"), path, line, params, stream)


def _param_kind(param: str) -> str:
    if "*" in param:
        return "pointer"
    words = [w for w in param.split() if w not in ("const", "volatile")]
    ctype = " ".join(words[:-1]) if len(words) > 1 else param
    return _C_SCALAR_KIND.get(ctype, ctype)


# ---------------------------------------------------------------------------
# Wrappers: call arity, launch counts, accumulator dtypes
# ---------------------------------------------------------------------------


def _entry_calls_by_function(
    contract: Contract, mod: ModuleInfo
) -> dict[ast.AST, list[tuple[ast.Call, tuple[str, ...]]]]:
    """Calls of library entries in ``mod``, grouped by enclosing def; each
    with the entry names it may call (several for a dict lookup)."""
    out: dict[ast.AST, list[tuple[ast.Call, tuple[str, ...]]]] = {}
    for node in ast.walk(mod.tree):
        if not isinstance(node, ast.Call):
            continue
        entries = _called_entries(contract, mod, node)
        if entries is None:
            continue
        fn = mod.enclosing_function(node) or mod.tree
        out.setdefault(fn, []).append((node, entries))
    return out


def _called_entries(
    contract: Contract, mod: ModuleInfo, call: ast.Call
) -> tuple[str, ...] | None:
    func = call.func
    if isinstance(func, ast.Attribute) and func.attr in contract.signatures:
        return (func.attr,)
    if not (
        isinstance(func, ast.Call)
        and isinstance(func.func, ast.Name)
        and func.func.id == "getattr"
        and len(func.args) >= 2
    ):
        return None
    names = _entry_names(mod, func.args[1], call)
    if names is None or not any(n in contract.signatures for n in names):
        return None
    return names


def _entry_names(
    mod: ModuleInfo, node: ast.AST, scope: ast.AST
) -> tuple[str, ...] | None:
    """The strings an entry-name expression may take: a literal, a local
    bound to one, or a lookup (``D[k]``, ``D.get(k)``) in a module-level
    dict literal of strings."""
    if isinstance(node, ast.Name):
        node = mod.resolve_local(node.id, scope)
    if isinstance(node, ast.Constant) and isinstance(node.value, str):
        return (node.value,)
    table = None
    if isinstance(node, ast.Subscript) and isinstance(node.value, ast.Name):
        table = node.value.id
    elif (
        isinstance(node, ast.Call)
        and isinstance(node.func, ast.Attribute)
        and node.func.attr == "get"
        and isinstance(node.func.value, ast.Name)
    ):
        table = node.func.value.id
    if table is None:
        return None
    d = _module_dict(mod, table)
    if d is None:
        return None
    values = [v.value for v in d.values
              if isinstance(v, ast.Constant) and isinstance(v.value, str)]
    return tuple(values) if len(values) == len(d.values) else None


def _check_wrappers(contract: Contract, mod: ModuleInfo) -> Iterator[Finding]:
    for fn, calls in _entry_calls_by_function(contract, mod).items():
        launching = False
        for call, entries in calls:
            yield from _check_arity(contract, mod, call, entries)
            if any(e in contract.launching for e in entries):
                launching = True
                yield from _check_status(mod, fn, call, entries)
        if launching:
            yield from _check_bump(contract, mod, fn, calls)
            yield from _check_alloc_dtypes(mod, fn)


def _check_arity(
    contract: Contract, mod: ModuleInfo, call: ast.Call, entries: tuple[str, ...]
) -> Iterator[Finding]:
    if any(isinstance(a, ast.Starred) for a in call.args):
        return
    got = len(call.args)
    for entry in entries:
        if entry not in contract.signatures:
            yield Finding(
                mod.path, call.lineno, CALL_ARITY_RULE,
                f"'{entry}' is not an entry of SIGNATURES",
            )
            continue
        want = len(contract.signatures[entry])
        if got != want or call.keywords:
            yield Finding(
                mod.path, call.lineno, CALL_ARITY_RULE,
                f"'{entry}' takes {want} positional argument(s) per "
                f"SIGNATURES, this call passes {got}"
                + (" and keywords ctypes ignores" if call.keywords else ""),
            )


def _check_status(
    mod: ModuleInfo, fn: ast.AST, call: ast.Call, entries: tuple[str, ...]
) -> Iterator[Finding]:
    parent = mod.parents.get(call)
    checked = isinstance(parent, ast.Call) and _is_check(mod, parent) and (
        parent.args and parent.args[0] is call
    )
    if (
        not checked
        and isinstance(parent, ast.Assign)
        and len(parent.targets) == 1
        and isinstance(parent.targets[0], ast.Name)
    ):
        status = parent.targets[0].id
        checked = any(
            isinstance(n, ast.Call)
            and _is_check(mod, n)
            and n.args
            and isinstance(n.args[0], ast.Name)
            and n.args[0].id == status
            for n in ast.walk(fn)
        )
    if not checked:
        yield Finding(
            mod.path, call.lineno, LAUNCH_COUNT_RULE,
            f"the status of launching entry '{entries[0]}' does not reach "
            "_build.check: a failed launch would pass silently",
        )


def _is_check(mod: ModuleInfo, call: ast.Call) -> bool:
    fq = mod.qualify(call.func) or ""
    return fq == "_build.check" or fq.endswith("._build.check")


def _launch_bumps(fn: ast.AST) -> Iterator[tuple[str | None, ast.AugAssign]]:
    """``LAUNCHES[<key>] += 1`` statements in ``fn`` (key None when it is
    not a string literal)."""
    for node in ast.walk(fn):
        if not (
            isinstance(node, ast.AugAssign)
            and isinstance(node.op, ast.Add)
            and isinstance(node.target, ast.Subscript)
        ):
            continue
        table = node.target.value
        name = (
            table.id if isinstance(table, ast.Name)
            else table.attr if isinstance(table, ast.Attribute) else None
        )
        if name != "LAUNCHES":
            continue
        key = node.target.slice
        yield (
            key.value if isinstance(key, ast.Constant)
            and isinstance(key.value, str) else None,
            node,
        )


def _check_bump(
    contract: Contract, mod: ModuleInfo, fn: ast.AST, calls
) -> Iterator[Finding]:
    bumps = list(_launch_bumps(fn))
    first = next(c for c, es in calls if any(e in contract.launching for e in es))
    if not bumps:
        yield Finding(
            mod.path, first.lineno, LAUNCH_COUNT_RULE,
            f"launch of '{_launching(contract, calls)}' is not counted: bump "
            "LAUNCHES[\"<kernel>\"] += 1 beside it, or the launch counts "
            "cannot see this kernel",
        )
    for key, node in bumps:
        one = isinstance(node.value, ast.Constant) and node.value.value == 1
        if key is None or key not in contract.launch_keys or not one:
            yield Finding(
                mod.path, node.lineno, LAUNCH_COUNT_RULE,
                "LAUNCHES bump must be += 1 on a literal key of "
                f"_build.LAUNCHES ({', '.join(contract.launch_keys)})",
            )


def _launching(contract: Contract, calls) -> str:
    return next(
        e for _, es in calls for e in es if e in contract.launching
    )


def _check_alloc_dtypes(mod: ModuleInfo, fn: ast.AST) -> Iterator[Finding]:
    for node in ast.walk(fn):
        if not isinstance(node, ast.Call):
            continue
        func = node.func
        fq = mod.qualify(func) or ""
        alloc = (fq.startswith("torch.") and fq[6:] in _ALLOC_FUNCS) or (
            isinstance(func, ast.Attribute) and func.attr in _ALLOC_METHODS
        )
        if not alloc:
            continue
        for kw in node.keywords:
            if kw.arg != "dtype":
                continue
            dq = (mod.qualify(kw.value) or "").rpartition(".")[2]
            if dq in _LOW_PRECISION:
                yield Finding(
                    mod.path, node.lineno, ACCUM_DTYPE_RULE,
                    f"{dq} buffer in a launching wrapper: outputs and "
                    "accumulators stay fp32 or integer even when the tiles "
                    "are bf16",
                )


def _check_stray_bumps(
    mod: ModuleInfo, contracts: list[Contract]
) -> Iterator[Finding]:
    """``LAUNCHES`` bumps in functions that launch nothing (the launch
    counts then count launches that did not happen)."""
    by_owner: dict[ast.AST, list[ast.AugAssign]] = {}
    for _, node in _launch_bumps(mod.tree):
        by_owner.setdefault(_owner(mod, node), []).append(node)
    for fn, bumps in by_owner.items():
        launches = any(
            e in c.launching
            for c in contracts
            for call in ast.walk(fn)
            if isinstance(call, ast.Call) and _owner(mod, call) is fn
            for e in _called_entries(c, mod, call) or ()
        )
        if not launches:
            for node in bumps:
                yield Finding(
                    mod.path, node.lineno, LAUNCH_COUNT_RULE,
                    "LAUNCHES bumped where no kernel is launched: only a "
                    "launch wrapper counts, beside its launch",
                )


def _owner(mod: ModuleInfo, node: ast.AST) -> ast.AST:
    return mod.enclosing_function(node) or mod.tree


# ---------------------------------------------------------------------------
# No fallback
# ---------------------------------------------------------------------------


def _check_fallbacks(
    mod: ModuleInfo, contracts: list[Contract]
) -> Iterator[Finding]:
    for node in ast.walk(mod.tree):
        if isinstance(node, (ast.Try, ast.TryStar)):
            guarded = any(_calls_kernel(mod, n, contracts) for s in node.body
                          for n in ast.walk(s))
            for handler in node.handlers:
                if guarded and not (
                    handler.body and isinstance(handler.body[-1], ast.Raise)
                ):
                    yield Finding(
                        mod.path, handler.lineno, NO_FALLBACK_RULE,
                        "handler around a CUDA kernel call does not end in "
                        "raise: a failed build or launch must fail the call, "
                        "not be swallowed",
                    )
        if isinstance(node, ast.ExceptHandler):
            for n in ast.walk(node):
                name = _call_name(n)
                if name is not None and name.endswith("_torch"):
                    yield Finding(
                        mod.path, n.lineno, NO_FALLBACK_RULE,
                        f"handler falls back to plain twin '{name}': a "
                        "kernel that fails raises, nothing falls back",
                    )


def _calls_kernel(
    mod: ModuleInfo, node: ast.AST, contracts: list[Contract]
) -> bool:
    name = _call_name(node)
    if name is None:
        return False
    return name.endswith("_cuda") or any(
        _called_entries(c, mod, node) is not None for c in contracts
    )


def _call_name(node: ast.AST) -> str | None:
    if not isinstance(node, ast.Call):
        return None
    func = node.func
    if isinstance(func, ast.Name):
        return func.id
    if isinstance(func, ast.Attribute):
        return func.attr
    return None


# ---------------------------------------------------------------------------
# Triton dot precision
# ---------------------------------------------------------------------------


def _check_triton_dots(mod: ModuleInfo) -> Iterator[Finding]:
    for fn in mod.functions.values():
        if not any(_is_triton_jit(mod, d) for d in fn.decorator_list):
            continue
        for node in ast.walk(fn):
            if not (
                isinstance(node, ast.Call)
                and mod.qualify(node.func) == "triton.language.dot"
            ):
                continue
            prec = next(
                (kw.value for kw in node.keywords
                 if kw.arg == "input_precision"),
                None,
            )
            if not (isinstance(prec, ast.Constant) and prec.value == "ieee"):
                yield Finding(
                    mod.path, node.lineno, TRITON_DOT_RULE,
                    f"tl.dot in '{fn.name}' without input_precision=\"ieee\": "
                    "TF32 products break index parity with the reference",
                )


def _is_triton_jit(mod: ModuleInfo, dec: ast.AST) -> bool:
    target = dec.func if isinstance(dec, ast.Call) else dec
    return mod.qualify(target) == "triton.jit"
