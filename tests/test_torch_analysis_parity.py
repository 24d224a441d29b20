"""The port's linter against the reference's on the same inputs.

The rules the two packages share (the three thread rules, the API-hygiene
table and the engine contract, suppressions, parse errors) must report the
same (path, line, rule, severity, suppressed) on every fixture of
``tests/test_repro_lint.py`` that touches them.  Two kinds of fixture are
re-expressed for the port with the same line numbers: the ``kv-deadline``
ones over a ``TCPStore`` (the port has no coordination client), and those
that exercise ``jit-host-sync`` over ``torch.compile``, whose findings the
port reports as ``host-sync``.  ``FileIndex`` and the reporters are copies
and must agree on the whole tree.
"""
import ast
import textwrap
from pathlib import Path

import pytest

import torch_threads  # noqa: F401 — one intra-op thread a worker
from repro.analysis import engine as ref_engine
from repro.analysis import findings as ref_findings
from repro.analysis import index as ref_index
from repro.analysis import report as ref_report
from repro_torch.analysis import engine as port_engine
from repro_torch.analysis import findings as port_findings
from repro_torch.analysis import index as port_index
from repro_torch.analysis import report as port_report

REPO = Path(__file__).resolve().parent.parent

SHARED = frozenset({
    "lock-discipline", "thread-join", "thread-failure-propagation",
    "kv-deadline", "flat-engine-knob", "forbidden-import",
    "engine-capabilities", "suppression-missing-reason", "parse-error",
    "host-sync",
})
# the reference's rule ids under their port names
PORT_ID = {"jit-host-sync": "host-sync"}

_JIT = "import jax\nimport jax.numpy as jnp\n\n@jax.jit\n"
_COMPILED = "import torch\nimport torch.nn as nn\n\n@torch.compile\n"

# (id, reference source, port source or None for the same, rule filter)
CASES = [
    ("lock-write-outside", '''
        import threading

        class Box:
            def __init__(self):
                self._lock = threading.Lock()
                self._val = 0

            def set_locked(self, v):
                with self._lock:
                    self._val = v

            def set_racy(self, v):
                self._val = v
        ''', None, None),
    ("thread-no-join-no-capture", '''
        import threading

        def work():
            raise RuntimeError("dies silently")

        def spawn():
            t = threading.Thread(target=work)
            t.start()
        ''', None, None),
    ("clean-worker", '''
        import threading

        class Runner:
            def __init__(self):
                self._lock = threading.Lock()
                self._result = None
                self._t = None

            def start(self):
                def work():
                    try:
                        out = 42
                        with self._lock:
                            self._result = out
                    except BaseException as e:
                        with self._lock:
                            self._result = e

                self._t = threading.Thread(target=work)
                self._t.start()

            def wait(self):
                self._t.join()
                with self._lock:
                    return self._result
        ''', None, None),
    ("kv-bare-get", '''
        def fetch(client, key):
            return client.blocking_key_value_get_bytes(key, 300_000)
        ''', '''
        def fetch(store, key):
            return store.get(key)
        ''', None),
    ("kv-inside-wrapper", '''
        def _raw_get_bytes(client, key, timeout_ms):
            return client.blocking_key_value_get_bytes(key, int(timeout_ms))
        ''', '''
        def _raw_get_bytes(store, key, timeout_ms):
            return store.get(key)
        ''', None),
    ("kv-suppressed", '''
        def probe(client, key):
            return client.blocking_key_value_get(key, 5)  # repro-lint: disable=kv-deadline  # fixture
        ''', '''
        def probe(store, key):
            return store.wait([key])  # repro-lint: disable=kv-deadline  # fixture
        ''', None),
    ("forbidden-pallas-import", '''
        from jax.experimental import pallas as pl

        def run(x):
            return x
        ''', None, None),
    ("suppressed-with-reason", "\n" + _JIT + '''def f(x):
    return x.item()  # repro-lint: disable=jit-host-sync  # fixture
''', "\n" + _COMPILED + '''def f(x):
    return x.item()  # repro-lint: disable=host-sync  # fixture
''', None),
    ("suppression-without-reason", "\n" + _JIT + '''def f(x):
    return x.item()  # repro-lint: disable=jit-host-sync
''', "\n" + _COMPILED + '''def f(x):
    return x.item()  # repro-lint: disable=host-sync
''', None),
    ("suppression-own-line", "\n" + _JIT + '''def f(x):
    y = x.item()  # repro-lint: disable=jit-host-sync  # fixture
    return x.tolist()
''', "\n" + _COMPILED + '''def f(x):
    y = x.item()  # repro-lint: disable=host-sync  # fixture
    return x.tolist()
''', None),
    ("parse-error", "def broken(:\n", None, None),
    ("rule-filter", '''
        import jax

        @jax.jit
        def f(x, device_q):
            return x.item()
        ''', None, frozenset({"flat-engine-knob"})),
    ("sorted-and-serializable", "\n" + _JIT.replace("import jax.numpy as jnp\n", "")
     + '''def f(x):
    a = x.item()
    b = x.tolist()
    return a, b
''', "\n" + _COMPILED.replace("import torch.nn as nn\n", "") + '''def f(x):
    a = x.item()
    b = x.tolist()
    return a, b
''', None),
]

# what the reference's tests assert of each fixture: (line, rule, suppressed)
EXPECTED = {
    "lock-write-outside": [(14, "lock-discipline", False)],
    "thread-no-join-no-capture": [(4, "thread-failure-propagation", False),
                                  (8, "thread-join", False)],
    "clean-worker": [],
    "kv-bare-get": [(3, "kv-deadline", False)],
    "kv-inside-wrapper": [],
    "kv-suppressed": [(3, "kv-deadline", True)],
    "forbidden-pallas-import": [(2, "forbidden-import", False)],
    "suppressed-with-reason": [(7, "host-sync", True)],
    "suppression-without-reason": [(7, "host-sync", False),
                                   (7, "suppression-missing-reason", False)],
    "suppression-own-line": [(7, "host-sync", True), (8, "host-sync", False)],
    "parse-error": [(1, "parse-error", False)],
    "rule-filter": [(5, "flat-engine-knob", False)],
    "sorted-and-serializable": [(6, "host-sync", False), (7, "host-sync", False)],
}


def _keys(result, as_port):
    out = []
    for f in result.findings:
        rid = PORT_ID.get(f.rule_id, f.rule_id) if as_port else f.rule_id
        if rid in SHARED:
            out.append((f.path, f.line, rid, f.severity, f.suppressed))
    return sorted(out)


@pytest.mark.parametrize("case", CASES, ids=[c[0] for c in CASES])
def test_shared_rules_match_the_reference(tmp_path, case):
    _, ref_src, port_src, rules = case
    pkg = tmp_path / "fx"  # a package: paths match from it down
    pkg.mkdir()
    (pkg / "__init__.py").write_text("")
    f = pkg / "snippet.py"
    f.write_text(textwrap.dedent(ref_src))
    ref = ref_engine.run_analysis([f], rule_filter=rules)
    f.write_text(textwrap.dedent(port_src if port_src is not None else ref_src))
    port = port_engine.run_analysis([f], rule_filter=rules)
    assert _keys(port, False) == _keys(ref, True)
    assert port.exit_code == ref.exit_code
    assert [(k[1], k[2], k[4]) for k in _keys(port, False)] == EXPECTED[case[0]]


def test_engine_registration_matches_the_reference(tmp_path):
    engines = tmp_path / "repro" / "core" / "engines"
    engines.mkdir(parents=True)
    (engines / "rogue.py").write_text(textwrap.dedent('''
        from repro.core.engines.base import SelectionEngine

        class RogueEngine(SelectionEngine):
            def select(self, gains):
                return gains
        '''))
    ref = ref_engine.run_analysis([engines])
    port = port_engine.run_analysis([engines])
    assert _keys(port, False) == _keys(ref, True)
    assert [f.rule_id for f in port.active] == ["engine-capabilities"] * 2


# ---------------------------------------------------------------------------
# FileIndex and the reporters
# ---------------------------------------------------------------------------


def _index_view(idx):
    view = {}
    for m in idx.modules:
        quals = [
            (n.lineno, n.col_offset, m.qualify(n)) for n in ast.walk(m.tree)
            if isinstance(n, (ast.Name, ast.Attribute))
        ]
        view[m.path] = (m.module, m.imports, sorted(m.functions),
                        sorted(m.classes), m.suppressions, quals)
    return view


@pytest.mark.parametrize("package", ["repro", "repro_torch"])
def test_file_index_matches_the_reference(package):
    root = REPO / "src" / package
    ref = ref_index.FileIndex.build([root])
    port = port_index.FileIndex.build([root])
    assert len(port.modules) == len(list(root.rglob("*.py"))) > 10
    rv, pv = _index_view(ref), _index_view(port)
    assert sorted(pv) == sorted(rv)
    differ = [p for p in rv if rv[p] != pv[p]]
    assert not differ, differ
    assert ([f.to_dict() for f in port.parse_findings + port.pragma_findings]
            == [f.to_dict() for f in ref.parse_findings + ref.pragma_findings])


def test_reporters_render_the_same_result():
    rows = [
        ("src/a.py", 3, "lock-discipline", "write outside the lock", "error", False),
        ("src/a.py", 9, "kv-deadline", "blocking get", "warning", True),
        ("src/b.py", 1, "parse-error", "invalid syntax", "error", False),
    ]
    ref = ref_engine.AnalysisResult([ref_findings.Finding(*r) for r in rows])
    port = port_engine.AnalysisResult([port_findings.Finding(*r) for r in rows])
    assert port_report.render_json(port) == ref_report.render_json(ref)
    for verbose in (False, True):
        assert (port_report.render_human(port, verbose=verbose)
                == ref_report.render_human(ref, verbose=verbose))
    clean = [r for r in rows if r[-1]]
    assert (port_report.render_human(port_engine.AnalysisResult(
        [port_findings.Finding(*r) for r in clean]))
        == ref_report.render_human(ref_engine.AnalysisResult(
            [ref_findings.Finding(*r) for r in clean])))
