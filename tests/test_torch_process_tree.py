"""The process-per-leaf tree (``repro_torch.distributed.process_tree``) and
its launcher (``repro_torch.launch.tree``), on the CPU.

Unit tests hold the wire primitives, the deadline knob, the heartbeat
monitor, the degraded candidate-count algebra and the quorum math — the
reference's health tests, against a dict-backed store and a real
in-process ``TCPStore``.  Two subprocess tests launch real processes over
a ``TCPStore`` on a free local port: four leaves whose selection must
equal the host driver's on the concatenated pool bit for bit, and a chaos
run whose killed leaf must degrade the survivors under quorum.
"""
import json
import os
import socket
import subprocess
import sys
import time
from pathlib import Path

import numpy as np
import pytest
import torch

from repro.distributed import process_tree as JP
from repro_torch.distributed.process_tree import (
    KV_TIMEOUT_ENV,
    HealthConfig,
    KVStoreError,
    QuorumError,
    _await_key,
    _decode_mask,
    _encode_mask,
    _Heartbeat,
    _HeartbeatMonitor,
    _kv_get,
    _node_r,
    _nominal_r,
    _poll_str,
    _put_cell,
    _require_quorum,
    kv_timeout_ms,
)
from repro_torch.distributed.tree_select import TreeTopology, tree_select_host
from repro_torch.faults import FaultPlan, FaultSpec, clear, injected
from repro_torch.launch.tree import _synthetic_pool, initialize_distributed
import torch_threads  # noqa: F401,E402 — one intra-op thread a worker

SRC = Path(__file__).resolve().parent.parent / "src"
_PROC_TIMEOUT = 120


class FakeStore:
    """Dict-backed stand-in for a ``TCPStore`` client: the five methods the
    wire uses."""

    def __init__(self):
        self.data: dict[str, bytes] = {}

    def set(self, key, value):
        self.data[key] = value.encode() if isinstance(value, str) else bytes(value)

    def get(self, key):
        if key not in self.data:
            raise RuntimeError(f"no key {key}")
        return self.data[key]

    def check(self, keys):
        return all(k in self.data for k in keys)

    def wait(self, keys, timeout):
        if not self.check(keys):
            raise RuntimeError(f"wait timeout after {timeout}, keys: {keys}")

    def add(self, key, n):
        v = int(self.data.get(key, b"0")) + int(n)
        self.data[key] = str(v).encode()
        return v


@pytest.fixture(autouse=True)
def _no_leaked_plan():
    yield
    clear()


def _free_port() -> int:
    s = socket.socket()
    s.bind(("127.0.0.1", 0))
    port = s.getsockname()[1]
    s.close()
    return port


# ---------------------------------------------------------------------------
# deadline knob and health config (the reference's rules)
# ---------------------------------------------------------------------------


@pytest.mark.parametrize("raw,want", [(None, 300_000), ("1500", 1500)])
def test_kv_timeout_default_and_env(monkeypatch, raw, want):
    if raw is None:
        monkeypatch.delenv(KV_TIMEOUT_ENV, raising=False)
    else:
        monkeypatch.setenv(KV_TIMEOUT_ENV, raw)
    assert kv_timeout_ms() == want == JP.kv_timeout_ms()


@pytest.mark.parametrize("bad", ["soon", "1.5", "0", "-10"])
def test_kv_timeout_rejects_bad_values(monkeypatch, bad):
    monkeypatch.setenv(KV_TIMEOUT_ENV, bad)
    with pytest.raises(ValueError, match=KV_TIMEOUT_ENV):
        kv_timeout_ms()


def test_health_config_validates_and_falls_back_to_env(monkeypatch):
    for kw, msg in ((dict(level_deadline_s=0), "level_deadline_s"),
                    (dict(heartbeat_interval_s=0), "heartbeat_interval_s"),
                    (dict(heartbeat_interval_s=1.0, heartbeat_grace_s=1.5), "2×"),
                    (dict(poll_ms=0), "poll_ms"), (dict(min_quorum=0.0), "min_quorum"),
                    (dict(min_quorum=1.1), "min_quorum")):
        with pytest.raises(ValueError, match=msg):
            HealthConfig(**kw)
    monkeypatch.setenv(KV_TIMEOUT_ENV, "2000")
    assert HealthConfig().deadline_s() == pytest.approx(2.0)
    assert HealthConfig(level_deadline_s=7.5).deadline_s() == 7.5


# ---------------------------------------------------------------------------
# wire primitives
# ---------------------------------------------------------------------------


def test_cells_masks_and_gets_on_a_fake_store():
    kv = FakeStore()
    assert _poll_str(kv, "t/sizes") is None
    _put_cell(kv, "t/sizes", "64,64,-1,64")
    assert _poll_str(kv, "t/sizes") == "64,64,-1,64"
    _put_cell(kv, "t/sizes2", "1")
    assert _poll_str(kv, "t/sizes") == "64,64,-1,64"
    mask = np.array([0, 1, 1, 0], np.int8)
    assert _encode_mask(mask) == "0110" == JP._encode_mask(mask)
    np.testing.assert_array_equal(_decode_mask("0110"), mask)
    arr = np.arange(8, dtype=np.float32).reshape(4, 2)
    kv.set("t/0/f", arr.tobytes())
    out = _kv_get(kv, "t/0/f", (4, 2), np.float32, pid=0, level=1,
                  what="child features", timeout_ms=50)
    np.testing.assert_array_equal(out, arr)
    with pytest.raises(KVStoreError) as ei:
        _kv_get(kv, "t/1/f", (4, 2), np.float32, pid=3, level=1,
                what="child features", timeout_ms=50)
    msg = str(ei.value)
    assert "'t/1/f'" in msg and "pid 3" in msg and "level 1" in msg
    assert "50 ms" in msg and "child features" in msg


def test_real_store_wire_deadline_and_drop_key():
    """A ``TCPStore`` hosted in this process: a missing key fails within its
    deadline, and a ``drop_key`` fault on ``kv.get`` surfaces as a
    ``KVStoreError`` at once, on both the blocking and the polled reads."""
    store = initialize_distributed(f"127.0.0.1:{_free_port()}", 1, 0, timeout_s=5)
    arr = np.arange(6, dtype=np.int64)
    store.set("t/0/g", arr.tobytes())
    np.testing.assert_array_equal(
        _kv_get(store, "t/0/g", (6,), np.int64, pid=0, level=1, what="ids",
                timeout_ms=1000), arr)
    t0 = time.monotonic()
    with pytest.raises(KVStoreError, match="'t/9/g'"):
        _kv_get(store, "t/9/g", (6,), np.int64, pid=0, level=1, what="ids", timeout_ms=300)
    assert time.monotonic() - t0 < 5.0
    _put_cell(store, "t/cell", "ready")
    plan = FaultPlan([FaultSpec(site="kv.get", kind="drop_key", key_pattern="t/0/g")])
    with injected(plan):
        t0 = time.monotonic()
        with pytest.raises(KVStoreError, match="FaultInjected"):
            _kv_get(store, "t/0/g", (6,), np.int64, pid=0, level=1, what="ids",
                    timeout_ms=30_000)
        assert time.monotonic() - t0 < 5.0  # the fault, not the 30 s deadline
        assert _poll_str(store, "t/cell") == "ready"  # another key still reads
    with injected(FaultPlan([FaultSpec(site="kv.get", kind="drop_key",
                                       key_pattern="t/cell")])):
        assert _poll_str(store, "t/cell") is None  # a dropped cell reads absent


# ---------------------------------------------------------------------------
# heartbeats and deadline waits
# ---------------------------------------------------------------------------


def test_heartbeat_counts_and_monitor_dead_after_silence():
    kv = FakeStore()
    hb = _Heartbeat(kv, "t", 1, interval_s=0.02)
    mon = _HeartbeatMonitor(kv, "t", 1, grace_s=0.15)
    time.sleep(0.1)
    assert mon.alive() and int(kv.get("t/hb/1")) >= 2
    hb.close()
    assert hb.error is None
    time.sleep(0.25)  # silence past the grace window
    assert not mon.alive()


def test_await_key_deadline_dead_publisher_and_final_probe():
    kv = FakeStore()
    _put_cell(kv, "t/k", "ready")
    assert _await_key(kv, "t/k", deadline_s=0.5, poll_ms=10) == "ready"
    t0 = time.monotonic()
    assert _await_key(kv, "t/none", deadline_s=0.2, poll_ms=10) is None
    assert 0.15 <= time.monotonic() - t0 < 2.0
    mon = _HeartbeatMonitor(kv, "t", 1, grace_s=0.05)
    time.sleep(0.1)  # publisher silent past grace
    t0 = time.monotonic()
    assert _await_key(kv, "t/none", deadline_s=30.0, poll_ms=10, monitor=mon) is None
    assert time.monotonic() - t0 < 5.0
    # publish-then-die: a committed publish is honoured by the final probe
    _put_cell(kv, "t/k2", "committed")
    mon2 = _HeartbeatMonitor(kv, "t", 2, grace_s=0.05)
    time.sleep(0.1)
    assert _await_key(kv, "t/k2", deadline_s=30.0, poll_ms=10, monitor=mon2) == "committed"


# ---------------------------------------------------------------------------
# degraded candidate counts and quorum (equal to the reference's)
# ---------------------------------------------------------------------------


@pytest.mark.parametrize("fanouts", [(4,), (2, 2), (4, 2)])
def test_node_r_equals_the_reference(fanouts):
    from repro.distributed.tree_select import TreeTopology as JTopology

    topo, jtopo = TreeTopology(fanouts), JTopology(fanouts)
    rng = np.random.default_rng(sum(fanouts))
    masks = [np.zeros(topo.n_leaves, np.int8), np.ones(topo.n_leaves, np.int8)]
    masks += [rng.integers(0, 2, topo.n_leaves).astype(np.int8) for _ in range(4)]
    for dead in masks:
        for level in range(topo.depth + 1):
            assert _nominal_r(level, topo, 8, 12, 10) == JP._nominal_r(level, jtopo, 8, 12, 10)
            for node in range(topo.nodes_at(level)):
                assert _node_r(level, node, dead, topo, 8, 12, 10) == JP._node_r(
                    level, node, dead, jtopo, 8, 12, 10)
    dead = np.array([0, 0, 0, 1], np.int8)
    assert _node_r(1, 0, dead, TreeTopology((4,)), 8, 16, 10) == 10


def test_require_quorum_boundary_and_failure():
    _require_quorum(3, 4, 0.75, level=1, node=0, missing=[3])  # exactly at
    with pytest.raises(QuorumError) as ei:
        _require_quorum(2, 4, 0.75, level=1, node=0, missing=[3, 1])
    msg = str(ei.value)
    assert "2/4" in msg and "min_quorum=0.75" in msg and "[1, 3]" in msg


# ---------------------------------------------------------------------------
# real processes (the launcher), each run with its own deadline
# ---------------------------------------------------------------------------


def _launch(nproc, args, victim_env=None):
    env = dict(os.environ, PYTHONPATH=str(SRC))
    env.pop("REPRO_FAULT_PLAN", None)
    common = ["--coordinator", f"127.0.0.1:{_free_port()}",
              "--num-processes", str(nproc), "--device", "cpu", *args]
    procs = []
    try:
        for i in range(nproc):
            e = dict(env, **victim_env) if victim_env and i == nproc - 1 else env
            procs.append(subprocess.Popen(
                [sys.executable, "-m", "repro_torch.launch.tree", "--process-id", str(i),
                 *common], env=e, stdout=subprocess.PIPE, stderr=subprocess.PIPE,
                text=True))
        outs = [p.communicate(timeout=_PROC_TIMEOUT) for p in procs]
    finally:
        for p in procs:
            if p.poll() is None:
                p.kill()
                p.wait()
    return procs, outs


def _record(out):
    lines = [ln for ln in out.splitlines() if ln.startswith("TREE_SELECT_RESULT ")]
    assert len(lines) == 1, out
    return json.loads(lines[0].split(" ", 1)[1])


def test_four_processes_equal_the_host_driver():
    """4 processes, fan-outs 2,2, the int8 wire, a ragged pool (1,022 rows):
    pids 0 and 2 own the level-1 nodes, pid 0 the root."""
    n, d = 1022, 16
    procs, outs = _launch(4, ["--fanouts", "2,2", "--n", str(n), "--d", str(d),
                              "--r-local", "12", "--r-final", "20"])
    for p, (_, err) in zip(procs, outs):
        assert p.returncode == 0, err[-3000:]
    recs = [_record(out) for out, _ in outs]
    assert all(r["indices"] == recs[0]["indices"] and r["weights"] == recs[0]["weights"]
               and r["coverage"] == recs[0]["coverage"] for r in recs)
    ref = tree_select_host(torch.from_numpy(_synthetic_pool(n, d, 0)), TreeTopology((2, 2)),
                           12, 20, compress="int8")
    assert ref.indices.tolist() == recs[0]["indices"]
    assert ref.weights.tolist() == recs[0]["weights"]
    assert float(ref.coverage) == recs[0]["coverage"]
    assert recs[0]["weight_sum"] == n and recs[0]["health"]["degraded"] is False
    assert recs[0]["wire_reduction"] >= 3.0


def test_killed_leaf_degrades_to_quorum():
    """pid 3 of 4 is SIGKILLed by an injected fault right before it
    publishes; the three survivors agree on one degraded selection within
    the deadline envelope, and Σγ covers only their shards."""
    plan = FaultPlan([FaultSpec(site="tree.publish", kind="kill")]).to_json()
    t0 = time.monotonic()
    procs, outs = _launch(4, ["--fanouts", "4", "--n", "256", "--d", "16",
                              "--r-local", "8", "--r-final", "10",
                              "--level-deadline-s", "20", "--min-quorum", "0.75",
                              "--heartbeat-interval-s", "0.2",
                              "--heartbeat-grace-s", "2.0"],
                          victim_env={"REPRO_FAULT_PLAN": plan})
    elapsed = time.monotonic() - t0
    assert procs[3].returncode == -9, outs[3][1][-2000:]
    for p, (_, err) in zip(procs[:3], outs[:3]):
        assert p.returncode == 0, err[-3000:]
    recs = [_record(out) for out, _ in outs[:3]]
    assert elapsed < 90, f"degraded run took {elapsed:.0f}s"
    assert all(r["indices"] == recs[0]["indices"] for r in recs)
    health = recs[0]["health"]
    assert health["degraded"] is True and health["missing_pids"] == [3]
    assert health["quorum"] == pytest.approx(0.75)
    assert recs[0]["weight_sum"] == 192.0 and max(recs[0]["indices"]) < 192
    assert len(set(recs[0]["indices"])) == 10


def test_mesh_driver_of_the_launcher_raises():
    """``--driver mesh``: two gloo processes equal ``tree_select_host`` bit
    for bit; a pool that does not divide over the leaves fails on every
    process with the reference's audit, and ``--device cuda`` raises before
    any group starts where there are fewer cards than processes (here,
    none)."""
    from repro_torch.launch import tree

    with pytest.raises(ValueError, match="host:port"):
        initialize_distributed("nowhere", 1, 0)
    a, b = _synthetic_pool(64, 8, 0), _synthetic_pool(64, 8, 0)
    assert a.dtype == np.float32 and np.array_equal(a, b)

    n, d = 1024, 16
    args = ["--driver", "mesh", "--fanouts", "2,2", "--d", str(d), "--r-local", "12",
            "--r-final", "20"]
    procs, outs = _launch(2, [*args, "--n", str(n)])
    for p, (_, err) in zip(procs, outs):
        assert p.returncode == 0, err[-3000:]
    recs = [_record(out) for out, _ in outs]
    assert [r["process"] for r in recs] == [0, 1]
    assert all(r["driver"] == "mesh" and r["device"] == "cpu" and r["health"] is None
               for r in recs)
    keys = ("indices", "weights", "coverage", "wire_bytes")
    assert all(tuple(r[k] for k in keys) == tuple(recs[0][k] for k in keys) for r in recs)
    ref = tree_select_host(torch.from_numpy(_synthetic_pool(n, d, 0)), TreeTopology((2, 2)),
                           12, 20, compress="int8")
    assert ref.indices.tolist() == recs[0]["indices"]
    assert ref.weights.tolist() == recs[0]["weights"]
    assert float(ref.coverage) == recs[0]["coverage"]
    assert recs[0]["weight_sum"] == n and recs[0]["wire_bytes"] == ref.wire[
        "gathered_feature_bytes"]

    procs, outs = _launch(2, [*args, "--n", str(n - 2)])
    for p, (out, err) in zip(procs, outs):
        assert p.returncode != 0 and "TREE_SELECT_RESULT" not in out
        assert "not divisible" in err, err[-3000:]

    with pytest.raises(ValueError, match="one rank per card"):
        tree.main(["--coordinator", "127.0.0.1:1", "--num-processes", "1",
                   "--process-id", "0", "--driver", "mesh", "--device", "cuda"])
