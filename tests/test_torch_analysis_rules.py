"""The port's repro-lint passes: fixtures for each of its 14 rule ids, the
CLI, and the contract the tree itself must keep.

Each rule id has at least one fixture it fires on (the right lines) and
one it stays quiet on.  ``test_torch_analysis_parity.py`` holds the rules
the port shares with the reference to the reference's own fixtures.
"""
import json
import os
import subprocess
import sys
import textwrap
from pathlib import Path

import pytest

import torch_threads  # noqa: F401 — one intra-op thread a worker
from repro_torch.analysis import FileIndex, all_rules, run_analysis
from repro_torch.analysis.rules import cuda_contract

REPO = Path(__file__).resolve().parent.parent
PORT = REPO / "src" / "repro_torch"

RULE_IDS = (
    "lock-discipline", "thread-join", "thread-failure-propagation",
    "kv-deadline", "flat-engine-knob", "forbidden-import",
    "engine-capabilities", "host-sync", "cuda-entry-signature",
    "cuda-call-arity", "cuda-launch-count", "cuda-no-fallback",
    "cuda-accumulator-dtype", "triton-dot-precision",
)


def _write(root: Path, files: dict[str, str]) -> None:
    """Write ``files`` (relative path -> source) under ``root``; the
    directories of a '.py' file up to ``root`` or a ``src`` directory
    become packages, as in a checkout."""
    for rel, src in files.items():
        path = root / rel
        path.parent.mkdir(parents=True, exist_ok=True)
        path.write_text(textwrap.dedent(src).lstrip("\n"))
        if path.suffix == ".py":
            d = path.parent
            while d != root and d.name != "src":
                (d / "__init__.py").touch()
                d = d.parent


def _lines(result, rule_id):
    return sorted(
        (Path(f.path).name, f.line) for f in result.active if f.rule_id == rule_id
    )


# ---------------------------------------------------------------------------
# concurrency and API hygiene over the port's paths
# ---------------------------------------------------------------------------

_RUNNER = '''
    import threading

    class Runner:
        def __init__(self):
            self._lock = threading.Lock()
            self._result = None
            self._t = None

        def start(self):
            def work():
                try:
                    with self._lock:
                        self._result = 42
                except BaseException as e:
                    with self._lock:
                        self._result = e

            self._t = threading.Thread(target=work)
            self._t.start()

        def wait(self):
            self._t.join()
            with self._lock:
                return self._result
    '''

_SPAWN = '''
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

    def work():
        raise RuntimeError("dies silently")

    def spawn():
        threading.Thread(target=work).start()
    '''

_STORE = '''
    def _raw_get_bytes(store, key, timeout_ms):
        store.wait([key])
        return store.get(key)

    def _poll_str(store, key):
        if not store.check([key]):
            return None
        return store.get(key).decode()

    class Barrier:
        def __init__(self, store):
            self._store = store

        def arrive(self, key):
            self._store.add(key, 1)
            self._store.set(key + "/seen", "1")
            return self._store.multi_get([key])

    def fetch(tcp_store, key, cache):
        cache.get(key)
        return tcp_store.wait([key])
    '''

_ENGINES = '''
    from repro_torch.core.engines.base import Capabilities, SelectionEngine
    from repro_torch.core.engines.registry import register_engine

    @register_engine
    class GoodEngine(SelectionEngine):
        capabilities = Capabilities(device_resident=True)

        def select(self, feats, budget):
            return feats[:budget]

    class RogueEngine(SelectionEngine):
        def select(self, feats, budget):
            return feats[:budget]
    '''

# (id, files, path to lint (relative), rule, expected (file name, line))
CASES = [
    ("lock-fires", {"w/box.py": _SPAWN}, "w", "lock-discipline", [("box.py", 13)]),
    ("lock-quiet", {"w/run.py": _RUNNER}, "w", "lock-discipline", []),
    ("join-fires", {"w/box.py": _SPAWN}, "w", "thread-join", [("box.py", 19)]),
    ("join-quiet", {"w/run.py": _RUNNER}, "w", "thread-join", []),
    ("failure-fires", {"w/box.py": _SPAWN}, "w", "thread-failure-propagation",
     [("box.py", 15)]),
    ("failure-quiet", {"w/run.py": _RUNNER}, "w", "thread-failure-propagation", []),
    ("kv-fires", {"w/tree.py": _STORE}, "w", "kv-deadline",
     [("tree.py", 17), ("tree.py", 21)]),
    ("kv-quiet", {"w/tree.py": _STORE.split("class Barrier")[0]}, "w",
     "kv-deadline", []),
    ("knob-fires", {"repro_torch/train/t.py": "def f(cfg):\n    return cfg.device_q\n"},
     "repro_torch", "flat-engine-knob", [("t.py", 2)]),
    ("knob-quiet-in-legacy",
     {"repro_torch/core/engines/legacy.py": "def f(cfg):\n    return cfg.device_q\n"},
     "repro_torch", "flat-engine-knob", []),
    ("imports-fire", {"repro_torch/core/x.py": '''
        import jax
        import ctypes
        from repro.core import craig
        from repro_torch.kernels import _build
        from repro_torch.core.engines.legacy import LegacyEngineKnobs
        import repro_torch.kernels.ops
        '''}, "repro_torch", "forbidden-import",
     [("x.py", 1), ("x.py", 2), ("x.py", 3), ("x.py", 4), ("x.py", 5)]),
    ("imports-quiet", {
        "repro_torch/kernels/k.py": "import ctypes\nfrom repro_torch.kernels import _build\n",
        "repro_torch/convert.py":
            "from repro_torch.core.engines.legacy import IMPL_FROM_REFERENCE\n",
        "repro_torch/core/craig.py": "from repro_torch.core.engines import legacy\n",
        "repro/core/r.py": "import jax\nfrom repro.core import craig\n",
    }, ".", "forbidden-import", []),
    # a checkout under a directory named 'repro' opens no row to the port
    ("imports-fire-under-a-repro-dir",
     {"repro/src/repro_torch/m.py": "import jax.numpy as jnp\n"},
     "repro/src/repro_torch", "forbidden-import", [("m.py", 1)]),
    ("engine-fires", {"repro_torch/core/engines/e.py": _ENGINES}, "repro_torch",
     "engine-capabilities", [("e.py", 11), ("e.py", 11)]),
    ("engine-quiet", {"repro_torch/core/engines/e.py": _ENGINES.split("class Rogue")[0]},
     "repro_torch", "engine-capabilities", []),
]

# ---------------------------------------------------------------------------
# host-sync
# ---------------------------------------------------------------------------

_HELPERS = '''
    import torch

    def to_host(x):
        return x.item()

    def pick(g):
        return int(torch.argmax(g))

    def sync_all():
        torch.cuda.synchronize()
    '''

_VMAP = '''
    import torch
    from pkg.helpers import to_host

    def body(x):
        y = x.to("cpu")
        return to_host(x) + y.to(device="cpu").sum()

    def run(xs):
        return torch.func.vmap(body)(xs)

    def capture(g, x):
        with torch.cuda.graph(g):
            y = x.numpy()
        return y
    '''

_RESIDENT = '''
    import numpy as np
    import torch
    from pkg.helpers import pick, sync_all
    from repro_torch.core.engines.base import Capabilities, SelectionEngine

    class Resident(SelectionEngine):
        capabilities = Capabilities(device_resident=True)

        def select(self, feats, budget):
            total = float(feats.sum())
            budget = int(min(budget, feats.shape[0]))
            first = pick(feats)
            out = []
            for t in range(budget):
                g = torch.argmax(feats[t:])
                out.append(int(g))
                if g > 0:
                    out.append(pick(feats))
                n = len(out) + feats.shape[0] + feats.numel()
                if n is None or t > n:
                    break
            sync_all()
            return np.asarray(out), total, first

        def select_cover(self, feats, budget):
            return [float(feats[i].max()) for i in range(budget)]

    class HostLoop(SelectionEngine):
        capabilities = Capabilities(device_resident=False)

        def select(self, feats, budget):
            return [feats[i].item() for i in range(budget)]
    '''

CASES += [
    ("sync-vmap-fires", {"pkg/helpers.py": _HELPERS, "pkg/main.py": _VMAP},
     "pkg", "host-sync",
     [("helpers.py", 4), ("main.py", 5), ("main.py", 6), ("main.py", 13)]),
    ("sync-vmap-quiet", {"pkg/helpers.py": _HELPERS,
                         "pkg/main.py": _VMAP.replace("torch.func.vmap(body)", "body")
                         .replace("torch.cuda.graph(g)", "torch.no_grad()")},
     "pkg", "host-sync", []),
    # in-loop syncs of select and of what the loop calls; one sync outside
    # every loop, select_cover and device_resident=False engines stay quiet
    ("sync-resident-loop-fires", {"pkg/helpers.py": _HELPERS, "pkg/eng.py": _RESIDENT},
     "pkg", "host-sync", [("eng.py", 16), ("eng.py", 17), ("helpers.py", 7)]),
    ("sync-resident-quiet", {
        "pkg/helpers.py": _HELPERS,
        "pkg/eng.py": _RESIDENT.replace("out.append(int(g))", "out.append(g)")
        .replace("if g > 0:", "if t > 0:").replace("out.append(pick(feats))", "pass"),
    }, "pkg", "host-sync", []),
]

# ---------------------------------------------------------------------------
# the CUDA wrapper contract: a fake kernels package
# ---------------------------------------------------------------------------

_BUILD = '''
    import ctypes

    LAUNCHES = {"foo": 0}

    _P = ctypes.c_void_p
    _I = ctypes.c_int
    SIGNATURES = {
        "foo": {
            "foo_block": (),
            "foo_f32": (_P,) * 2 + (_I,) + (_P,),
        },
    }


    def check(status, what):
        if status != 0:
            raise RuntimeError(what)
    '''

_CU = '''
    // extern "C" { int not_an_entry(int x) { return x; } }
    __global__ void k(const float* x, float* out, int n) {
      if (threadIdx.x < n) out[threadIdx.x] = x[threadIdx.x];
    }

    extern "C" {

    /* the block width: int commented_out(void* stream) { */
    int foo_block() { return 64; }

    int foo_f32(const void* x, void* out,
                int n, void* stream) {
      k<<<1, 32, 0, static_cast<cudaStream_t>(stream)>>>(
          static_cast<const float*>(x), static_cast<float*>(out), n);
      return (int)cudaGetLastError();
    }

    }  // extern "C"
    '''

_WRAP = '''
    import torch

    from kern import _build

    LAUNCHES = _build.LAUNCHES
    _ENTRY = {torch.float32: "foo_f32"}


    def foo_cuda(x):
        lib = _build.library("foo")
        width = lib.foo_block()
        out = torch.empty(x.shape, dtype=torch.float32, device=x.device)
        status = getattr(lib, _ENTRY[x.dtype])(x.data_ptr(), out.data_ptr(), width, 0)
        _build.check(status, "foo")
        LAUNCHES["foo"] += 1
        return out


    def foo_torch(x):
        return x.clone()


    def foo(x):
        try:
            return foo_cuda(x)
        except ValueError as e:
            raise RuntimeError("foo failed") from e
    '''


def _kern(build=_BUILD, cu=_CU, wrap=_WRAP, extra=None):
    files = {"kern/_build.py": build, "kern/csrc/foo.cu": cu, "kern/wrap.py": wrap}
    files.update(extra or {})
    return files


_CUDA_IDS = ("cuda-entry-signature", "cuda-call-arity", "cuda-launch-count",
             "cuda-no-fallback", "cuda-accumulator-dtype")
CASES += [(f"{rid}-quiet", _kern(), "kern", rid, []) for rid in _CUDA_IDS]
CASES += [
    ("signature-count", _kern(build=_BUILD.replace("(_P,) * 2 + (_I,) + (_P,)",
                                                   "(_P,) * 2 + (_I,)")),
     "kern", "cuda-entry-signature", [("_build.py", 10)]),
    ("signature-kind", _kern(build=_BUILD.replace("(_P,) * 2 + (_I,) + (_P,)",
                                                  "(_P,) * 3 + (_P,)")),
     "kern", "cuda-entry-signature", [("_build.py", 10)]),
    ("signature-unexported-row", _kern(build=_BUILD.replace('"foo_block": (),\n', "")),
     "kern", "cuda-entry-signature", [("foo.cu", 9)]),
    ("signature-missing-def", _kern(build=_BUILD.replace('"foo_block": (),',
                                                         '"foo_block": (), "gone": (),')),
     "kern", "cuda-entry-signature", [("_build.py", 9)]),
    ("signature-unreadable", _kern(build=_BUILD.replace('"foo_block": ()',
                                                        '"foo_block": list()')),
     "kern", "cuda-entry-signature", [("_build.py", 9)]),
    ("call-arity", _kern(wrap=_WRAP.replace("width, 0)", "0)")),
     "kern", "cuda-call-arity", [("wrap.py", 13)]),
    ("call-arity-literal", _kern(wrap=_WRAP.replace(
        'getattr(lib, _ENTRY[x.dtype])', 'getattr(lib, "foo_f32")').replace(
        "lib.foo_block()", "lib.foo_block(1)")),
     "kern", "cuda-call-arity", [("wrap.py", 11)]),
    ("launch-without-check", _kern(wrap=_WRAP.replace(
        '_build.check(status, "foo")', "pass")),
     "kern", "cuda-launch-count", [("wrap.py", 13)]),
    ("launch-without-bump", _kern(wrap=_WRAP.replace('LAUNCHES["foo"] += 1', "pass")),
     "kern", "cuda-launch-count", [("wrap.py", 13)]),
    ("launch-bad-key", _kern(wrap=_WRAP.replace('LAUNCHES["foo"] += 1',
                                                'LAUNCHES["bar"] += 1')),
     "kern", "cuda-launch-count", [("wrap.py", 15)]),
    ("launch-stray-bump", _kern(wrap=_WRAP.replace(
        "return x.clone()", 'LAUNCHES["foo"] += 1\n    return x.clone()')),
     "kern", "cuda-launch-count", [("wrap.py", 20)]),
    ("fallback-swallowed", _kern(wrap=_WRAP.replace(
        'raise RuntimeError("foo failed") from e', "return None")),
     "kern", "cuda-no-fallback", [("wrap.py", 26)]),
    ("fallback-to-twin", _kern(wrap=_WRAP.replace(
        'raise RuntimeError("foo failed") from e', "return foo_torch(x)")),
     "kern", "cuda-no-fallback", [("wrap.py", 26), ("wrap.py", 27)]),
    ("fallback-twin-anywhere", _kern(extra={"kern/use.py": '''
        from kern.wrap import foo_torch

        def run(x, y):
            try:
                return x / y
            except ZeroDivisionError:
                return foo_torch(x)
        '''}), "kern", "cuda-no-fallback", [("use.py", 7)]),
    ("bf16-output", _kern(wrap=_WRAP.replace("dtype=torch.float32", "dtype=torch.bfloat16")),
     "kern", "cuda-accumulator-dtype", [("wrap.py", 12)]),
    ("bf16-outside-a-launch", _kern(wrap=_WRAP.replace(
        "return x.clone()", "return torch.zeros(3, dtype=torch.bfloat16)")),
     "kern", "cuda-accumulator-dtype", []),
]

# scalars by value: ctypes.c_float against a C float parameter
_FLOAT_BUILD = _BUILD.replace("_I = ctypes.c_int\n",
                              "_I = ctypes.c_int\n    _F = ctypes.c_float\n")
_FLOAT_CU = _CU.replace("int n, void* stream)", "int n, float lr, void* stream)")
_FLOAT_WRAP = _WRAP.replace("width, 0)", "width, 0.5, 0)")
CASES += [
    ("signature-float-quiet", _kern(
        build=_FLOAT_BUILD.replace("(_P,) * 2 + (_I,) + (_P,)", "(_P,) * 2 + (_I, _F) + (_P,)"),
        cu=_FLOAT_CU, wrap=_FLOAT_WRAP), "kern", "cuda-entry-signature", []),
    ("signature-float-as-int", _kern(
        build=_FLOAT_BUILD.replace("(_P,) * 2 + (_I,) + (_P,)", "(_P,) * 2 + (_I, _I) + (_P,)"),
        cu=_FLOAT_CU, wrap=_FLOAT_WRAP), "kern", "cuda-entry-signature", [("_build.py", 11)]),
]

_TRITON = '''
    import triton
    import triton.language as tl


    @triton.jit
    def kernel(a_ptr, o_ptr):
        a = tl.load(a_ptr)
        b = tl.dot(a, a)
        c = tl.dot(a, a, input_precision="ieee")
        tl.store(o_ptr, b + c)


    def host(a):
        return tl.dot(a, a)
    '''
CASES += [
    ("triton-fires", {"tk/k.py": _TRITON}, "tk", "triton-dot-precision", [("k.py", 8)]),
    ("triton-quiet", {"tk/k.py": _TRITON.replace("tl.dot(a, a)\n        c",
                                                 'tl.dot(a, a, input_precision="ieee")\n'
                                                 "        c")},
     "tk", "triton-dot-precision", []),
]


@pytest.mark.parametrize("case", CASES, ids=[c[0] for c in CASES])
def test_rule_fixture(tmp_path, case):
    _, files, target, rule_id, expected = case
    _write(tmp_path, files)
    result = run_analysis([tmp_path / target])
    assert _lines(result, rule_id) == sorted(expected), [
        f.format() for f in result.active]


def test_every_rule_has_a_firing_and_a_quiet_fixture():
    fires = {c[3] for c in CASES if c[4]}
    quiet = {c[3] for c in CASES if not c[4]}
    assert fires == quiet == set(RULE_IDS)
    assert sorted(r for rule in all_rules() for r in rule.rule_ids) == sorted(RULE_IDS)


def test_fake_contract_classifies_its_entries(tmp_path):
    _write(tmp_path, _kern())
    [c] = cuda_contract.read_contracts(FileIndex.build([tmp_path / "kern"]))
    assert c.signatures == {"foo_block": (), "foo_f32": ("pointer",) * 2
                            + ("int", "pointer")}
    assert c.launching == {"foo_f32"}
    assert c.bumped_keys() == {"kern.wrap.foo_cuda": {"foo"}}


# ---------------------------------------------------------------------------
# the tree's own contract and the CLI
# ---------------------------------------------------------------------------


def _cli(*args):
    env = dict(os.environ, PYTHONPATH=str(REPO / "src"))
    return subprocess.run([sys.executable, "-m", "repro_torch.analysis", *args],
                          cwd=REPO, env=env, capture_output=True, text=True,
                          timeout=300)


@pytest.fixture(scope="module")
def tree_report():
    """``python -m repro_torch.analysis --format json``: the default path
    is the port's tree."""
    proc = _cli("--format", "json")
    return proc.returncode, json.loads(proc.stdout), proc.stderr


def test_the_port_is_clean_and_its_suppressions_are_listed(tree_report):
    rc, report, err = tree_report
    assert rc == 0, json.dumps(report["findings"], indent=1) + err
    assert report["counts"]["active"] == 0 and report["exit_code"] == 0
    assert report["schema"] == 1
    sites = sorted((f["path"], f["line"], f["rule_id"])
                   for f in report["findings"] if f["suppressed"])
    # a new pragma shows here in review
    assert sites == [("src/repro_torch/core/engines/device.py", 145, "host-sync")]


def test_the_tree_keeps_its_kernel_contract():
    from repro_torch.kernels import _build

    [c] = cuda_contract.read_contracts(FileIndex.build([PORT]))
    assert not c.findings
    assert len(c.signatures) == 18 == len(c.prototypes)
    assert set(c.signatures) == {e for s in _build.SIGNATURES.values() for e in s}
    assert len(c.launching) == 10
    assert all(e.endswith(("_f32", "_bf16")) for e in c.launching)
    assert c.signatures["adamw_update_f32"].count("float") == 10
    bumps = c.bumped_keys()
    assert len(bumps) == 8 and all(len(k) == 1 for k in bumps.values())
    assert set().union(*bumps.values()) == set(_build.LAUNCHES) == set(c.launch_keys)


def test_cli_lists_rules_and_exits_2_on_an_unknown_one():
    listed = _cli("--list-rules")
    assert listed.returncode == 0
    assert [ln.split(":")[0] for ln in listed.stdout.splitlines()] == sorted(RULE_IDS)
    unknown = _cli("src/repro_torch", "--rules", "no-such-rule")
    assert unknown.returncode == 2 and "unknown rule" in unknown.stderr
    missing = _cli("no/such/dir")
    assert missing.returncode == 2


def test_cli_exits_1_on_a_bad_file(tmp_path):
    bad = tmp_path / "bad.py"
    bad.write_text("import torch\n\n@torch.compile\ndef f(x):\n    return x.item()\n")
    proc = _cli(str(bad), "--format", "json")
    assert proc.returncode == 1
    report = json.loads(proc.stdout)
    assert report["counts"]["by_rule"] == {"host-sync": 1}
    assert _cli(str(bad), "--rules", "kv-deadline").returncode == 0
