"""The port's dry run (``launch/dryrun.py``) against the reference's and
against real CPU runs of the same steps.

* Cell arithmetic, every arch × shape (select_pool included): the
  reference's ``model_flops``, ``param_count``, ``active_param_count``,
  ``microbatches_for`` and which cells ``SkipCell`` skips, exactly.
* The trace, at smoke width for every family (dense, MoE, Griffin, xLSTM,
  the embeddings frontend with M-RoPE, codebook heads) and every kind
  (train, prefill, decode, select): its FLOPs equal, exactly, what
  ``FlopCounterMode`` counts over a real CPU run of the same step, though
  the trace runs three iterations of each long loop (``models/loops.py``);
  its bytes accessed lie within 2% and its peak within 5% of what the
  same counter reads over the real run; its argument bytes are what the
  shapes give.
* A homogeneous stack's probes extrapolate to its full-depth trace exactly.
* Against the reference's ``cost_analysis()``: XLA counts every
  elementwise op as FLOPs where ``torch.utils.flop_counter`` counts the
  products alone, so the port's count lies below the reference's, by the
  share of elementwise work (stated at the test).

The reference's ``launch/dryrun.py`` is imported at module level, as
``tests/test_roofline_tools.py`` imports it: its first lines set
``XLA_FLAGS`` to 512 host devices, which takes effect only where no JAX
backend exists yet (that file already does so at collection, in every
worker of a run).
"""
import dataclasses

import jax
import numpy as np
import pytest
import torch
from torch.utils.flop_counter import FlopCounterMode

from repro.launch import dryrun as jdry  # noqa: I001 — sets XLA_FLAGS, as test_roofline_tools
from repro.configs.registry import get_config as jget_config
from repro.configs.registry import smoke_config as jsmoke_config
from repro.configs.shapes import SHAPES as JSHAPES
from repro.configs.shapes import ShapeSpec as JShapeSpec
from repro.models import init_params as jinit_params
from repro.serve import make_prefill_step as jmake_prefill_step
from repro_torch.configs.registry import ARCHS, get_config, smoke_config
from repro_torch.configs.shapes import SHAPES, ShapeSpec
from repro_torch import roofline
from repro_torch.kernels import ops
from repro_torch.launch import dryrun
from repro_torch.models import init_params, param_shapes
import torch_threads  # noqa: F401,E402 — one intra-op thread a worker

SHAPE_NAMES = list(SHAPES) + ["select_pool"]


class _PastTheSkip(Exception):
    pass


def _past(*a, **k):
    raise _PastTheSkip


@pytest.mark.parametrize("arch", sorted(ARCHS))
def test_cell_arithmetic_matches_reference(arch, monkeypatch):
    cfg, jcfg = get_config(arch), jget_config(arch)
    assert cfg.param_count() == jcfg.param_count()
    assert cfg.active_param_count() == jcfg.active_param_count()
    # the reference's build_cell checks the skip before it builds anything
    monkeypatch.setattr(jdry.jax, "eval_shape", _past)
    for name in SHAPE_NAMES:
        shape = dryrun.SELECT_POOL if name == "select_pool" else SHAPES[name]
        jshape = (JShapeSpec("select_pool", 4096, 256, "select") if name == "select_pool"
                  else JSHAPES[name])
        assert dryrun.model_flops(cfg, shape) == jdry.model_flops(jcfg, jshape), name
        assert dryrun.microbatches_for(shape, cfg) == jdry.microbatches_for(jshape, jcfg), name
        with pytest.raises((jdry.SkipCell, _PastTheSkip)) as ref:
            jdry.build_cell(arch, name, None)
        try:
            dryrun.build_cell(arch, name)
            skipped = False
        except dryrun.SkipCell:
            skipped = True
        assert skipped == (ref.type is jdry.SkipCell), (arch, name)


FAMILIES = {"dense": "qwen3-1.7b", "moe": "moonshot-v1-16b-a3b", "griffin": "recurrentgemma-9b",
            "xlstm": "xlstm-1.3b", "mrope": "qwen2-vl-7b", "codebooks": "musicgen-medium"}
# T = 40 with 8-token attention chunks past a 16-token blockwise threshold:
# 5 × 5 causal chunks, 5 mLSTM chunks, 40 sLSTM steps, each loop traced
# as three iterations; the dense train step in 4 microbatches (MICRO).
T = 40
MICRO = ShapeSpec("train", 24, 128, "train")
KINDS = {"train": ShapeSpec("train", T, 4, "train"), "prefill": ShapeSpec("prefill", T, 2,
                                                                         "prefill"),
         "decode": ShapeSpec("decode", T, 3, "decode"), "select": ShapeSpec("select", T, 2,
                                                                            "select")}


def _family(name: str):
    """The family's smoke config at one pattern period (xLSTM's (7 × mlstm,
    slstm) period as one cell of each), with T = 40's chunks."""
    cfg = smoke_config(FAMILIES[name])
    pattern = ("mlstm", "slstm") if name == "xlstm" else cfg.block_pattern
    return dataclasses.replace(cfg, block_pattern=pattern, n_layers=len(pattern),
                               blockwise_threshold=16, attn_chunk_q=8, attn_chunk_kv=8)


def _real_args(cell, seed=0):
    """The cell's arguments as real CPU tensors: seeded weights and inputs
    (optimizer and serve states as the step starts them, zero)."""
    cfg = cell["cfg"]
    args = cell["make_args"](torch.device("cpu"))
    gen = torch.Generator().manual_seed(seed)
    for k, v in init_params(cfg, gen).items():
        args[0][k].copy_(v)
    for name, t in args[-1].items():
        if name == "positions":
            t.copy_(torch.arange(t.shape[-1]).expand(t.shape))
        elif name == "weights":
            t.copy_(torch.rand(t.shape, generator=gen) + 0.5)
        elif t.is_floating_point():
            t.copy_(torch.randn(t.shape, generator=gen))
        else:
            t.copy_(torch.randint(0, cfg.vocab_size, t.shape, generator=gen))
    return args


def _nbytes(struct: dict) -> int:
    return sum(int(np.prod(s)) * torch.empty((), dtype=dt).element_size()
               for s, dt in struct.values())


@pytest.mark.parametrize("kind", sorted(KINDS))
@pytest.mark.parametrize("family", sorted(FAMILIES))
def test_trace_flops_equal_a_real_run(family, kind):
    cfg = _family(family)
    # the dense train step in 4 microbatches (of 32 sequences) at T = 24;
    # the other families' attention covers the chunk loops
    shape = MICRO if (family, kind) == ("dense", "train") else KINDS[kind]
    cell = dryrun.build_cell(cfg, shape)
    rec = dryrun.reckon(cell["fn"], cell["make_args"], "cpu")
    args = _real_args(cell)
    with FlopCounterMode(display=False) as fc, dryrun.Reckoner(args) as real:
        cell["fn"](*args)
    assert rec["cost"]["flops"] == fc.get_total_flops() > 0
    # bytes and memory of the real run, counted the same way over every
    # iteration: the stitched loop outputs move a few more bytes, and a
    # loop's collected outputs are counted at its end (largest readings:
    # bytes +1.04% for the Griffin decode step, peak +3.9% for the xLSTM
    # prefill)
    assert rec["cost"]["bytes accessed"] == pytest.approx(real.bytes, rel=2e-2)
    assert rec["memory"]["temp_size_in_bytes"] == pytest.approx(real.peak, rel=5e-2)
    assert rec["cost"]["flops_bf16"] + rec["cost"]["flops_fp32"] == rec["cost"]["flops"]

    params = 4 * sum(int(np.prod(s)) for s in param_shapes(cfg).values())
    shape = cell["shape"]
    if kind == "train":
        want = 3 * params + _nbytes(dryrun.train_batch_struct(cfg, shape))  # + AdamW m, v
    elif kind == "select":
        struct = dryrun.train_batch_struct(cfg, shape)
        struct.pop("weights")
        want = params + _nbytes(struct)
    else:
        want = params + _nbytes(dryrun.infer_batch_struct(cfg, shape, kind == "decode"))
        if kind == "decode":
            want += sum(t.untyped_storage().nbytes() for t in dryrun._tensors(args[1]))
    assert rec["memory"]["argument_size_in_bytes"] == want
    assert rec["memory"]["peak_bytes"] >= want
    assert cell["meta"].get("microbatches", 1) == (4 if shape is MICRO else 1)
    if kind in ("train", "prefill") and family in ("xlstm", "dense"):
        scaled = {"xlstm": {"40", "5"}, "dense": {"4"} if kind == "train" else {"5", "4"}}
        assert scaled[family] <= set(rec["scaled_loops"]), rec["scaled_loops"]


@pytest.mark.parametrize("family,kind,layers", [("dense", "prefill", 3), ("griffin", "decode", 9)])
def test_probes_extrapolate_to_the_full_trace(family, kind, layers):
    """X(full) = X(p1) + (periods − 1)·(X(p2) − X(p1)), exactly, for a stack
    of whole periods."""
    cfg = dataclasses.replace(_family(family), n_layers=layers)
    periods = layers // len(cfg.block_pattern)
    got = {p: dryrun.reckon(*(lambda c: (c["fn"], c["make_args"]))(
        dryrun.build_cell(cfg, KINDS[kind], probe=p)), "cpu")["cost"]
        for p in (0, 1, 2)}
    for key in ("flops", "flops_bf16", "flops_fp32", "bytes accessed"):
        a, b = got[1][key], got[2][key]
        assert a + (periods - 1) * (b - a) == got[0][key], key


def test_trace_flops_against_the_reference_cost_analysis():
    """The dense smoke prefill step at T = 16 (dense attention: no loop
    XLA would cost once), unrolled: the port counts the products; XLA's
    ``cost_analysis`` also counts each elementwise op (norms, softmax,
    RoPE, SiLU), so the port's count lies below the reference's, at
    0.8–1.0 of it (0.865 read)."""
    arch = "qwen3-1.7b"
    jcfg = dataclasses.replace(jsmoke_config(arch), scan_layers=False)
    shape = ShapeSpec("prefill", 16, 4, "prefill")
    rec = dryrun.reckon(*(lambda c: (c["fn"], c["make_args"]))(
        dryrun.build_cell(smoke_config(arch), shape)), "cpu")
    jp = jax.eval_shape(lambda: jinit_params(jax.random.PRNGKey(0), jcfg))
    batch = jdry.infer_batch_struct(jcfg, JShapeSpec("prefill", 16, 4, "prefill"), False)
    cost = jax.jit(jmake_prefill_step(jcfg)).lower(jp, batch).compile().cost_analysis()
    cost = cost[0] if isinstance(cost, (list, tuple)) else cost
    ratio = rec["cost"]["flops"] / float(cost["flops"])
    assert 0.8 <= ratio <= 1.0, ratio


def test_ce_proxy_op_traces_without_launching():
    """The ``ce_proxy`` kernel's custom op: on fake tensors it launches
    nothing and returns its (T, D) fp32 shape; its FLOPs are the two
    products, 4·T·V·D; a launch splits tokens below 2**31 elements."""
    from torch._subclasses.fake_tensor import FakeTensorMode

    before = dict(ops.LAUNCHES)
    with FakeTensorMode():
        h = torch.empty(96, 32, dtype=torch.bfloat16)
        w = torch.empty(200, 32, dtype=torch.bfloat16)
        y = torch.empty(96, dtype=torch.int32)
        with FlopCounterMode(display=False) as fc:
            g = torch.ops.repro_torch.ce_proxy(h, w, y, 190)
    assert tuple(g.shape) == (96, 32) and g.dtype == torch.float32
    assert fc.get_total_flops() == 4 * 96 * 200 * 32
    assert dict(ops.LAUNCHES) == before
    assert ops.token_slice(256 * 4096, 2048) == 2**19  # two launches at select_pool
    assert ops.token_slice(32768, 2048) == 32768
    assert all(ops.token_slice(t, d) * d < 2**31 for t, d in ((2**20, 2048), (2**22, 6144)))


def test_cli_writes_artifacts_the_roofline_reports(tmp_path, capsys):
    assert dryrun.main(["--arch", "qwen3-1.7b", "--shape", "decode_32k", "long_500k",
                        "--probes-only", "--device", "cpu", "--out", str(tmp_path)]) == 0
    names = sorted(p.name for p in tmp_path.iterdir())
    assert names == [f"qwen3-1.7b__{s}__h100x1__p{p}.json"
                     for s in ("decode_32k", "long_500k") for p in (1, 2)]
    assert "[skip ] qwen3-1.7b long_500k" in capsys.readouterr().out
    roofline.main(["--out", str(tmp_path), "--markdown"])
    rows = [r for r in capsys.readouterr().out.splitlines() if r.startswith("| qwen3")]
    assert len(rows) == 1 and "| decode_32k | serve_step |" in rows[0]
    # the reference's 16×16 mesh: per-device artifacts beside the card's
    assert dryrun.main(["--arch", "qwen3-1.7b", "--shape", "decode_32k", "--probes-only",
                        "--mesh", "single", "--device", "cpu", "--out", str(tmp_path)]) == 0
    assert sorted(p.name for p in tmp_path.iterdir() if "16x16" in p.name) == [
        f"qwen3-1.7b__decode_32k__16x16__p{p}.json" for p in (1, 2)]
    capsys.readouterr()
    roofline.main(["--out", str(tmp_path), "--mesh", "single", "--markdown"])
    rows = [r.split(" | ") for r in capsys.readouterr().out.splitlines()
            if r.startswith("| qwen3")]
    assert len(rows) == 1 and float(rows[0][5]) > 0  # a collective term


# --- per device on the reference's 16×16 mesh (slice 13) ---------------------

MESH_KINDS = {"train": ShapeSpec("train", 16, 32, "train"),
              "decode": ShapeSpec("decode", 16, 32, "decode"),
              "select": ShapeSpec("select", 16, 32, "select")}


def _local_bytes(shapes: dict, specs: dict, sizes: dict, itemsize=4) -> int:
    """Bytes one device holds of tensors placed by ``specs`` (each split even)."""
    total = 0
    for k, s in shapes.items():
        n = int(np.prod(s))
        for a in specs[k]:
            for g in (a if isinstance(a, tuple) else (a,) if a else ()):
                n //= sizes[g]
        total += n * (itemsize[k] if isinstance(itemsize, dict) else itemsize)
    return total


def _mesh_reckon(cfg, shape):
    from repro_torch.distributed import annotate
    from repro_torch.launch.mesh import fake_world, make_production_mesh

    with fake_world(256, "cpu"):
        mesh = make_production_mesh(device_type="cpu")
        cell = dryrun.build_cell(cfg, shape, mesh=mesh)
        with annotate.mesh_context(mesh, cell["dp_over_model"]):
            return cell, dryrun.reckon(cell["fn"], cell["make_args"], "cpu")


@pytest.mark.parametrize("kind", sorted(MESH_KINDS))
def test_a_mesh_cell_counts_one_device(kind):
    """A smoke-width cell under a fake 256-rank group: its argument bytes are
    one device's by the spec arithmetic (parameters by ``param_specs``, or
    ``serve_param_specs`` for decode; AdamW's moments alike; the batch by
    ``batch_specs``, ``dp_over_model`` for a dense select step; the serve
    state by ``serve_state_specs``), and a train step issues collectives."""
    from repro_torch.distributed import sharding as shd

    cfg, shape = smoke_config("qwen3-1.7b"), MESH_KINDS[kind]
    sizes = {"data": 16, "model": 16}
    stand_in = dataclasses.make_dataclass("Mesh", ["axis_names", "shape"])(tuple(sizes), sizes)
    cell, rec = _mesh_reckon(cfg, shape)
    shapes = param_shapes(cfg)
    specs = (shd.serve_param_specs if kind == "decode" else shd.param_specs)(shapes, stand_in)
    want = _local_bytes(shapes, specs, sizes) * (3 if kind == "train" else 1)
    struct = (dryrun.infer_batch_struct(cfg, shape, True) if kind == "decode"
              else dryrun.train_batch_struct(cfg, shape))
    if kind == "select":
        struct.pop("weights")
    bshapes = {k: s for k, (s, _) in struct.items()}
    bspecs = shd.batch_specs(stand_in, bshapes, dp_over_model=kind == "select")
    want += _local_bytes(bshapes, bspecs, sizes,
                         {k: torch.empty((), dtype=dt).element_size()
                          for k, (_, dt) in struct.items()})
    if kind == "decode":
        from repro_torch.models import init_serve_state

        state = init_serve_state(cfg, shape.global_batch, shape.seq_len, "meta")["layers"]
        sspecs = shd.serve_state_specs(state, stand_in, shape.global_batch)
        for layer, spec in zip(state, sspecs):
            want += _local_bytes({k: t.shape for k, t in layer.items()}, spec, sizes,
                                 {k: t.element_size() for k, t in layer.items()})
    assert rec["memory"]["argument_size_in_bytes"] == want
    assert cell["dp_over_model"] == (kind == "select")
    if kind == "train":
        assert rec["collectives"]["all_reduce"]["count"] > 0
        assert rec["collective_bytes_total"] == sum(
            c["bytes"] for c in rec["collectives"].values()) > 0


def test_a_scaled_loop_on_a_mesh_counts_as_the_whole_loop(monkeypatch):
    """Blockwise attention's chunk loop traced as three iterations on a fake
    16×16 mesh counts the FLOPs of the whole loop traced, each device's."""
    import contextlib

    cfg = dataclasses.replace(smoke_config("qwen3-1.7b"), blockwise_threshold=16,
                              attn_chunk_q=8, attn_chunk_kv=8)
    shape = ShapeSpec("train", 48, 16, "train")
    _, scaled = _mesh_reckon(cfg, shape)
    assert scaled["scaled_loops"], scaled["scaled_loops"]
    monkeypatch.setattr(dryrun.loops, "counting", lambda count: contextlib.nullcontext())
    _, whole = _mesh_reckon(cfg, shape)
    assert not whole["scaled_loops"]
    assert scaled["cost"]["flops"] == whole["cost"]["flops"] > 0


def test_a_product_on_a_mesh_counts_one_devices_flops():
    """A product of DTensors on a fake 16×16 mesh counts one device's FLOPs,
    2·(M/16)·K·(N/16) exactly: DTensor's run of the product at the global
    shapes (its sharding propagation, which computes the output's metadata)
    is no device's work.  Shapes no other test takes, so that propagation
    runs here rather than hitting DTensor's cache."""
    from repro_torch.launch.mesh import fake_world, make_production_mesh

    M, K, N = 80, 56, 48
    with fake_world(256, "cpu"):
        mesh = make_production_mesh(device_type="cpu")
        rec = dryrun.reckon(
            lambda x, w: x @ w,
            lambda device: (dryrun._alloc((M, K), torch.float32, device, mesh, ("data", None)),
                            dryrun._alloc((K, N), torch.float32, device, mesh, (None, "model"))),
            "cpu")
    assert rec["cost"]["flops"] == 2 * (M // 16) * K * (N // 16)


def test_a_mesh_train_cell_counts_a_share_of_the_one_card_flops():
    """The smoke dense train cell on a fake 16×16 mesh counts per device at
    most 1/16 of the same cell's FLOPs on one card (its batch of 32 is
    split over ``data``; the products split over ``model`` where the
    widths divide) and at least 1/256 of them (no device does less than
    its share).  A global-shape run of each op counted as a device's puts
    the count at about half the one-card trace's.  A sequence length no
    other test takes, so that DTensor's propagation runs here rather than
    hitting its cache."""
    cfg, shape = smoke_config("qwen3-1.7b"), ShapeSpec("train", 24, 32, "train")
    one = dryrun.build_cell(cfg, shape)
    whole = dryrun.reckon(one["fn"], one["make_args"], "cpu")["cost"]["flops"]
    _, rec = _mesh_reckon(cfg, shape)
    per_device = rec["cost"]["flops"]
    assert whole / 256 <= per_device <= whole / 16, (per_device, whole)
