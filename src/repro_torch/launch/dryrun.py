"""Dry run: reckon every (arch × shape) cell on fake tensors, on one H100
or per device of the reference's 256- and 512-device meshes.

Port of ``repro.launch.dryrun``.  For each cell this driver builds the
real step — the γ-weighted train step (AdamW, microbatched), the prefill
step, the serve step against a ``seq_len``-deep cache, or the CRAIG
select step — and, in place of the reference's lower-and-compile against
``ShapeDtypeStruct``s, traces it once under
``torch._subclasses.fake_tensor.FakeTensorMode``: every tensor carries
its shape, dtype and device and no memory is allocated, so a cell one
card cannot hold (qwen3-1.7b's ``decode_32k`` KV cache is ~481 GB) is
reckoned all the same.  The trace records, as the reference's artifact:

  * ``memory`` — argument bytes (parameters, optimizer state, the batch
    or the serve state; on a mesh also the arguments less the batch, and
    those of the full-depth cell for a probe, as placed), output bytes
    (new storages among the outputs),
    and the peak of live bytes during the step: every storage an op
    creates counts from its creation until it is freed, as PyTorch's
    caching allocator counts ``max_memory_allocated`` less its 512-byte
    rounding;
  * ``cost`` — FLOPs by the dtype of each product's operands
    (``torch.utils.flop_counter``'s formulas: matrix products, the
    ``ce_proxy`` kernel's custom op; elementwise work is not counted),
    and bytes accessed: over every op that writes a tensor (not a view
    or a metadata query), the bytes of its tensor inputs plus its
    outputs (an op that returns nothing, the tensors it writes in place).
    Eager PyTorch fuses nothing, so
    this is what the eager program moves, each op's operands read once;
  * ``collectives`` — the census of collectives by kind (``all_gather``,
    ``reduce_scatter``, ``all_reduce``, ``all_to_all``): a count and the
    output bytes of each ``_c10d_functional`` op one device issues
    (``wait_tensor`` counts nothing), as the reference parses its HLO;
    ``{}`` on one card;
  * ``model_flops`` (6·N·D train, 2·N·D inference, N active), ``params``,
    ``active_params``, ``tokens_per_step``, ``wall_s``; and, new, the
    card (name, memory bytes), the trace device and ``method``: how each
    count was made and which loops were scaled.

Loops (``models/loops.py``): the sLSTM's steps, the mLSTM's and
blockwise attention's chunks and the microbatches run their first, second
and last iterations in the trace, the second counted for the n − 2 in the
middle (forward, its recompute under remat, and its backward, found by
the autograd node's sequence number).  FLOPs stay exact: each middle
iteration repeats the second's products.  Bytes count the second's ops
n − 2 times; memory counts what the second made and the loop's end still
holds (saved for the backward, collected) n − 2 times; the stitched
outputs (``loops.widen``) add a few ops the real loop lacks.

Meshes (``--mesh``): ``h100x1``, one card; ``single`` and ``multi``, the
reference's 16×16 ``("data", "model")`` and 2×16×16 ``("pod", "data",
"model")`` meshes, each cell traced in one process under
``launch/mesh.py::fake_world`` (PyTorch's fake backend: a 256- or
512-rank group whose collectives move nothing) with the reference's
recipe: parameters placed by ``distributed/sharding.py``'s
``param_specs`` and the optimizer state like them (train, prefill,
select), ``serve_param_specs`` for decode when the batch fills the data
axis, the serve state by ``serve_state_specs``, the batch by
``batch_specs`` (``seq_shard`` for a batch of one, ``dp_over_model``
for a dense arch's select step, as ``annotate.set_mesh`` is set around
the trace).  The Reckoner then steps aside for every DTensor-level op and
counts the local ops each device runs: FLOPs, bytes, argument and peak
bytes are one device's (rank 0's), and ``n_devices`` the mesh's.

Artifacts go to ``artifacts/dryrun_torch/<arch>__<shape>__<mesh>[__pN].json``
(``h100x1``, ``16x16``, ``2x16x16``); ``repro_torch.roofline`` reads them.
A probe (``__p1``, ``__p2``) has ``probe × len(block_pattern)`` layers
and one microbatch, as the reference's; the roofline extrapolates the
full depth from the two.  The trace runs on ``--device`` (default
``cuda``: fake tensors on the card's device type, which the CPU-only
build cannot make; the CPU tests and a machine without a card pass
``--device cpu``, and the select step then takes its CPU head, the einsum
path, where the card takes the ``ce_proxy`` kernel; the fake CPU group
also has no all-to-all, and DTensor lowers one to an all-gather there).

Usage::

    PYTHONPATH=src python -m repro_torch.launch.dryrun --arch qwen3-1.7b \\
        --shape train_4k --probes --device cpu
    PYTHONPATH=src python -m repro_torch.launch.dryrun --all --probes-only
    PYTHONPATH=src python -m repro_torch.launch.dryrun --all --probes-only --mesh single
    PYTHONPATH=src python -m repro_torch.roofline --markdown [--mesh 16x16]
"""
from __future__ import annotations

import argparse
import bisect
import contextlib
import dataclasses
import json
import math
import os
import sys
import threading
import time
import traceback
import weakref
from collections import Counter

import torch
from torch._subclasses.fake_tensor import FakeTensorMode
from torch.distributed.tensor import DTensor
from torch.utils._python_dispatch import TorchDispatchMode, _disable_current_modes
from torch.utils._pytree import tree_leaves
from torch.utils.flop_counter import flop_registry
from torch.utils.weak import WeakIdKeyDictionary

from repro_torch.configs.registry import ARCHS, get_config
from repro_torch.configs.shapes import SHAPES, ShapeSpec
from repro_torch.distributed import annotate
from repro_torch.distributed import sharding as shd
from repro_torch.launch.mesh import PRODUCTION_MESHES, fake_world, make_production_mesh
from repro_torch.models import loops
from repro_torch.models.config import ModelConfig
from repro_torch.models.model import init_serve_state, param_shapes
from repro_torch.optim.optimizers import adamw, warmup_cosine
from repro_torch.roofline import CARD, CARDS, MESH, MESH_TAGS
from repro_torch.serve.serve_step import make_prefill_step, make_serve_step
from repro_torch.train.train_step import make_select_step, make_train_step

__all__ = ["SELECT_POOL", "MESH_TAGS", "SkipCell", "Reckoner", "microbatches_for",
           "train_batch_struct", "infer_batch_struct", "build_cell", "model_flops", "reckon",
           "run_cell", "main"]

ARTIFACT_DIR = os.path.join(os.path.dirname(__file__), "../../../artifacts/dryrun_torch")

SELECT_POOL = ShapeSpec("select_pool", 4096, 256, "select")

# metadata queries that FlopCounterMode leaves to the next mode, as here
_QUERIES = {
    torch.ops.aten.sym_is_contiguous.default, torch.ops.aten.is_contiguous.default,
    torch.ops.aten.is_contiguous.memory_format, torch.ops.aten.is_strides_like_format.default,
    torch.ops.aten.is_non_overlapping_and_dense.default, torch.ops.aten.size.default,
    torch.ops.aten.sym_size.default, torch.ops.aten.stride.default,
    torch.ops.aten.sym_stride.default, torch.ops.aten.storage_offset.default,
    torch.ops.aten.sym_storage_offset.default, torch.ops.aten.numel.default,
    torch.ops.aten.sym_numel.default, torch.ops.aten.dim.default, torch.ops.prim.layout.default,
}
# ops that allocate without writing
_NO_TRAFFIC = {torch.ops.aten.empty, torch.ops.aten.empty_strided, torch.ops.aten.empty_like,
               torch.ops.aten.new_empty, torch.ops.aten.new_empty_strided}
_HALF = (torch.bfloat16, torch.float16)

# _c10d_functional op → census kind (the reference's HLO opcode names)
_COLLECTIVES = {
    "all_gather_into_tensor": "all_gather", "all_gather_into_tensor_coalesced": "all_gather",
    "reduce_scatter_tensor": "reduce_scatter",
    "reduce_scatter_tensor_coalesced": "reduce_scatter",
    "all_reduce": "all_reduce", "all_reduce_": "all_reduce",
    "all_reduce_coalesced": "all_reduce", "all_reduce_coalesced_": "all_reduce",
    "all_to_all_single": "all_to_all",
}


class SkipCell(Exception):
    pass


def _tensors(tree) -> list:
    """The tensors of ``tree``, a DTensor as its local shard (what one
    device holds)."""
    return [t._local_tensor if isinstance(t, DTensor) else t
            for t in tree_leaves(tree) if isinstance(t, torch.Tensor)]


def _operand_bytes(tree) -> int:
    return sum(t.numel() * t.element_size() for t in _tensors(tree))


def _written(func, args, kwargs) -> list:
    """The tensors an op writes in place (its schema's ``Tensor(a!)``
    arguments): what a mutating op that returns nothing, such as
    ``repro_torch::adamw_update``, writes."""
    named = dict(zip((a.name for a in func._schema.arguments), args), **kwargs)
    return _tensors([named.get(a.name) for a in func._schema.arguments
                     if a.alias_info is not None and a.alias_info.is_write])


def _aliases(outs: list, inputs) -> bool:
    """Every output is a view of an input (a view moves no bytes)."""
    ins = {id(t.untyped_storage()) for t in _tensors(inputs)}
    return all(id(t.untyped_storage()) in ins for t in outs)


_PROPAGATION = threading.local()


def _in_sharding_propagation() -> bool:
    """Whether this thread runs inside DTensor's sharding propagation, which
    computes an op's output metadata by running it on the global shapes:
    work no device does (marked by :func:`_marking_propagation`)."""
    return getattr(_PROPAGATION, "depth", 0) > 0


@contextlib.contextmanager
def _marking_propagation():
    """Mark DTensor's global-shape metadata runs for the block, by wrapping
    the one method that makes them; a PyTorch release without that method
    raises here rather than have its runs counted as a device's work."""
    from torch.distributed.tensor._sharding_prop import ShardingPropagator

    run = ShardingPropagator._propagate_tensor_meta_non_cached

    def marked(self, op_schema):
        _PROPAGATION.depth = getattr(_PROPAGATION, "depth", 0) + 1
        try:
            return run(self, op_schema)
        finally:
            _PROPAGATION.depth -= 1

    ShardingPropagator._propagate_tensor_meta_non_cached = marked
    try:
        yield
    finally:
        ShardingPropagator._propagate_tensor_meta_non_cached = run


def _flop_kind(args) -> str:
    """'bf16' when every floating operand is half width (tensor cores),
    else 'fp32' (CUDA cores: the port runs with TF32 off)."""
    fl = [t.dtype for t in _tensors(args) if t.is_floating_point()]
    return "bf16" if fl and all(d in _HALF for d in fl) else "fp32"


def _sequence_nr() -> int:
    """The autograd sequence number the next node of this thread takes
    (one throwaway node on the real CPU)."""
    with _disable_current_modes(), torch.enable_grad():
        return torch.zeros((), requires_grad=True).view(()).grad_fn._sequence_nr() + 1


class Reckoner(TorchDispatchMode):
    """Counts FLOPs by dtype, bytes accessed and live storage bytes of the
    ops under it (below autograd, above ``FakeTensorMode``).

    ``repeat(n)`` (installed as ``loops``' counter) counts the ops in its
    block n times; the backward of the nodes created in the block is
    counted n times too.  Storages created in the block that outlive the
    whole loop weigh n times their bytes (the callable it yields, run by
    ``loops.steps`` after the loop's last iteration).
    """

    def __init__(self, args=()):
        super().__init__()
        self.flops = {"bf16": 0, "fp32": 0}
        self.bytes = 0
        self.collectives: dict[str, dict[str, int]] = {}
        self.trips = Counter()  # loop trip counts scaled, by count
        self.live = self.peak = 0
        self._scale = 1
        self._starts: list[int] = []  # sequence-number pieces (start, end, scale)
        self._pieces: list[tuple[int, int, int]] = []
        self._open: list[tuple[int, int]] = []  # regions not yet closed (lo, n)
        self._live: dict[int, list[int]] = {}  # allocation → [bytes, weight]
        self._ids = WeakIdKeyDictionary()  # storage → allocation (−1: an argument)
        self._next = 0
        for t in _tensors(args):
            self._ids[t.untyped_storage()] = -1
        self._mesh = any(isinstance(t, DTensor) for t in tree_leaves(args))

    # -- scaling -----------------------------------------------------------
    def _node_scale(self, nr: int) -> int:
        scale = 1
        for lo, n in self._open:  # a backward inside its loop's body
            if nr >= lo:
                scale *= n
        i = bisect.bisect_right(self._starts, nr) - 1
        if i >= 0 and nr <= self._pieces[i][1]:
            scale *= self._pieces[i][2]
        return scale

    def _current_scale(self) -> int:
        node = torch._C._current_autograd_node()
        if node is not None and not torch.is_grad_enabled():  # a backward function
            return self._node_scale(node._sequence_nr())
        return self._scale  # a forward, or a recompute under remat

    @contextlib.contextmanager
    def repeat(self, n: int):
        forward = torch.is_grad_enabled() and torch._C._current_autograd_node() is None
        lo = _sequence_nr() if forward else 0
        first = self._next
        self._scale *= n
        if forward:
            self._open.append((lo, n))
        try:
            yield lambda: self._weigh(first, last, n)
        finally:
            self._scale //= n
            last = self._next - 1
            self.trips[n + 2] += 1
            if forward:
                self._open.pop()
                self._cover(lo, _sequence_nr() - 1, n)

    def _cover(self, lo: int, hi: int, n: int) -> None:
        """Scale the nodes numbered lo…hi by n (pieces inside already are)."""
        i = bisect.bisect_left(self._starts, lo)
        pieces, at = [], lo
        for s, e, k in self._pieces[i:]:
            if s > at:
                pieces.append((at, s - 1, n))
            pieces.append((s, e, k * n))
            at = e + 1
        if at <= hi:
            pieces.append((at, hi, n))
        self._pieces[i:] = pieces
        self._starts[i:] = [p[0] for p in pieces]

    def _weigh(self, first: int, last: int, n: int) -> None:
        """Storages made first…last (one repeated iteration) and alive now,
        after the loop, weigh n times."""
        for a in reversed(self._live):
            if a < first:
                break
            if a <= last:
                rec = self._live[a]
                self.live += (n - 1) * rec[0] * rec[1]
                rec[1] *= n
        self.peak = max(self.peak, self.live)

    # -- storage -------------------------------------------------------------
    def _free(self, a: int) -> None:
        nbytes, weight = self._live.pop(a)
        self.live -= nbytes * weight

    def _track(self, out) -> None:
        for t in _tensors(out):
            st = t.untyped_storage()
            if st in self._ids:
                continue
            a, self._next = self._next, self._next + 1
            self._ids[st] = a
            self._live[a] = [st.nbytes(), 1]
            self.live += st.nbytes()
            weakref.finalize(st, self._free, a)
        self.peak = max(self.peak, self.live)

    def new_bytes(self, tree) -> int:
        """Bytes of the distinct storages in ``tree`` made during the trace."""
        seen = {}
        for t in _tensors(tree):
            st = t.untyped_storage()
            a = self._ids.get(st, -1)
            if a >= 0:
                seen[a] = st.nbytes() * self._live.get(a, [0, 1])[1]
        return sum(seen.values())

    # -- dispatch --------------------------------------------------------------
    def __torch_dispatch__(self, func, types, args=(), kwargs=None):
        kwargs = kwargs or {}
        # a DTensor-level op: step aside, and count the local ops it runs
        if func in _QUERIES or any(issubclass(t, DTensor) for t in types):
            return NotImplemented
        if self._mesh and _in_sharding_propagation():
            return func(*args, **kwargs)
        # as FlopCounterMode: an op without a formula is decomposed if it can be
        if func not in flop_registry and func is not torch.ops.prim.device.default:
            with self:
                r = func.decompose(*args, **kwargs)
                if r is not NotImplemented:
                    return r
        out = func(*args, **kwargs)
        scale = self._current_scale()
        packet = func._overloadpacket
        if packet in flop_registry:
            self.flops[_flop_kind(args)] += scale * flop_registry[packet](
                *args, **kwargs, out_val=out)
        outs = _tensors(out) or (_written(func, args, kwargs) if func._schema.is_mutable else [])
        kind = _COLLECTIVES.get(func.__name__.split(".")[0]) \
            if func.namespace == "_c10d_functional" else None
        if kind is not None:
            rec = self.collectives.setdefault(kind, {"count": 0, "bytes": 0})
            rec["count"] += scale
            rec["bytes"] += scale * _operand_bytes(outs)
        if outs and packet not in _NO_TRAFFIC and (func._schema.is_mutable
                                                   or not _aliases(outs, (args, kwargs))):
            self.bytes += scale * (_operand_bytes((args, kwargs)) + _operand_bytes(outs))
        self._track(out)
        return out


def _storage_bytes(tree) -> int:
    return sum({id(t.untyped_storage()): t.untyped_storage().nbytes()
                for t in _tensors(tree)}.values())


def state_bytes(make_args, device) -> int:
    """One device's bytes of a cell's arguments less its batch (the last
    argument): parameters with the optimizer state or the serve state, as
    placed, made on fake tensors without tracing the step."""
    with FakeTensorMode():
        return _storage_bytes(make_args(torch.device(device))[:-1])


def reckon(fn, make_args, device) -> dict:
    """Trace ``fn(*make_args(device))`` on fake tensors; the counts."""
    with FakeTensorMode():
        args = make_args(torch.device(device))
        counter = Reckoner(args)
        marking = _marking_propagation() if counter._mesh else contextlib.nullcontext()
        with marking, loops.counting(counter.repeat), counter:
            out = fn(*args)
        out_bytes = counter.new_bytes(out)
        del out
    arg_bytes = _storage_bytes(args)
    return {
        "memory": {"argument_size_in_bytes": arg_bytes, "output_size_in_bytes": out_bytes,
                   "temp_size_in_bytes": counter.peak,
                   "peak_bytes": arg_bytes + counter.peak},
        "cost": {"flops": float(sum(counter.flops.values())),
                 "flops_bf16": float(counter.flops["bf16"]),
                 "flops_fp32": float(counter.flops["fp32"]),
                 "bytes accessed": float(counter.bytes)},
        "scaled_loops": {str(n): c for n, c in sorted(counter.trips.items())},
        "collectives": counter.collectives,
        "collective_bytes_total": sum(c["bytes"] for c in counter.collectives.values()),
    }


def microbatches_for(shape: ShapeSpec, cfg: ModelConfig) -> int:
    """The reference's microbatch count (its per-microbatch token target:
    16 sequences for wide MoE models, else 32)."""
    if shape.kind != "train":
        return 1
    per_mb_target = 16 if (cfg.d_model >= 6144 and cfg.n_experts) else 32
    return max(1, shape.global_batch // per_mb_target)


def train_batch_struct(cfg: ModelConfig, shape: ShapeSpec) -> dict:
    """{name: (shape, dtype)} of a train or select batch, the reference's
    layout."""
    B, T = shape.global_batch, shape.seq_len
    batch: dict = {}
    if cfg.frontend == "tokens":
        batch["tokens"] = ((B, T), torch.int32)
    else:
        batch["embeddings"] = ((B, T, cfg.d_model), torch.bfloat16)
    if cfg.n_codebooks > 1:
        batch["labels"] = ((B, T, cfg.n_codebooks), torch.int32)
    else:
        batch["labels"] = ((B, T), torch.int32)
    if cfg.mrope_sections is not None:
        batch["positions"] = ((B, 3, T), torch.int32)
    batch["weights"] = ((B,), torch.float32)
    return batch


def infer_batch_struct(cfg: ModelConfig, shape: ShapeSpec, decode: bool) -> dict:
    """{name: (shape, dtype)} of a prefill or decode batch."""
    B = shape.global_batch
    T = 1 if decode else shape.seq_len
    batch: dict = {}
    if cfg.frontend == "tokens":
        batch["tokens"] = ((B, T), torch.int32)
    else:
        batch["embeddings"] = ((B, T, cfg.d_model), torch.bfloat16)
    if cfg.mrope_sections is not None and not decode:
        batch["positions"] = ((B, 3, T), torch.int32)
    return batch


def _alloc(shape, dtype, device, mesh=None, spec=None) -> torch.Tensor:
    """An empty tensor; on a mesh, a DTensor placed by ``spec`` whose local
    shard is a storage of its own (each spec divides its dims evenly)."""
    if mesh is None:
        return torch.empty(shape, dtype=dtype, device=device)
    from torch.distributed.tensor import DTensor, Shard

    placements = shd.to_placements(spec, mesh)
    local = list(shape)
    for i, p in enumerate(placements):
        if isinstance(p, Shard):
            local[p.dim] //= mesh.size(i)
    return DTensor.from_local(torch.empty(local, dtype=dtype, device=device), mesh, placements,
                              run_check=False, shape=torch.Size(shape),
                              stride=torch.empty(shape, device="meta").stride())


def _empty(struct: dict, device, mesh=None, **batch_kw) -> dict:
    specs = shd.batch_specs(mesh, {k: s for k, (s, _) in struct.items()}, **batch_kw) \
        if mesh is not None else {}
    return {k: _alloc(s, dt, device, mesh, specs.get(k)) for k, (s, dt) in struct.items()}


def _params(cfg: ModelConfig, device, mesh=None, serve: bool = False) -> dict:
    # from the shapes: init_params' truncated normal reads a value (.item())
    shapes = param_shapes(cfg)
    specs = {} if mesh is None else (shd.serve_param_specs if serve else shd.param_specs)(
        shapes, mesh)
    return {k: _alloc(s, torch.float32, device, mesh, specs.get(k)) for k, s in shapes.items()}


def _serve_state(cfg: ModelConfig, batch: int, max_len: int, device, mesh=None) -> dict:
    state = init_serve_state(cfg, batch, max_len, device)
    if mesh is None:
        return state
    specs = shd.serve_state_specs(state["layers"], mesh, batch)
    return {"layers": [{k: _alloc(t.shape, t.dtype, device, mesh, specs[i][k])
                        for k, t in layer.items()} for i, layer in enumerate(state["layers"])],
            "pos": state["pos"]}


def build_cell(arch: str | ModelConfig, shape: str | ShapeSpec, probe: int = 0,
               mesh=None) -> dict:
    """The cell's step: {fn, make_args(device) → args, meta, cfg, shape,
    dp_over_model}.

    ``arch`` is a registered name or a config; ``shape`` a name in
    ``SHAPES``, ``'select_pool'``, or a ``ShapeSpec`` (a cut batch).
    ``probe > 0`` keeps ``probe`` pattern periods and one microbatch.
    With a ``DeviceMesh`` the arguments are placed by the reference's
    recipe (the module's docstring)."""
    cfg = get_config(arch) if isinstance(arch, str) else arch
    if probe:
        cfg = dataclasses.replace(cfg, n_layers=probe * len(cfg.block_pattern))
    if isinstance(shape, str):
        shape = SELECT_POOL if shape == "select_pool" else SHAPES[shape]
    if shape.name == "long_500k" and not cfg.is_subquadratic:
        raise SkipCell(f"{cfg.name} is full-attention; long_500k requires a sub-quadratic "
                       "architecture (DESIGN.md §Arch-applicability)")
    cell = {"cfg": cfg, "shape": shape, "dp_over_model": False}
    seq = {"seq_shard": shape.global_batch == 1}

    if shape.kind == "train":
        opt = adamw(warmup_cosine(3e-4, 2000, 100_000))
        mb = 1 if probe else microbatches_for(shape, cfg)
        batch = train_batch_struct(cfg, shape)

        def make_args(device):
            params = _params(cfg, device, mesh)
            # the moments are made like their parameters: placed alike
            return params, opt.init(params), _empty(batch, device, mesh, **seq)

        return {**cell, "fn": make_train_step(cfg, opt, microbatches=mb), "make_args": make_args,
                "meta": {"microbatches": mb, "step": "train_step"}}

    if shape.kind == "prefill":
        batch = infer_batch_struct(cfg, shape, decode=False)
        return {**cell, "fn": make_prefill_step(cfg), "meta": {"step": "prefill_step"},
                "make_args": lambda device: (_params(cfg, device, mesh),
                                             _empty(batch, device, mesh, **seq))}

    if shape.kind == "decode":
        batch = infer_batch_struct(cfg, shape, decode=True)
        B = shape.global_batch
        # serving weights without ZeRO-3, unless the batch leaves data-parallel
        # replicas idle (long_500k's batch of one): then ZeRO-3 storage is cheaper
        serve = mesh is not None and B >= shd.mesh_shape(mesh).get("data", 1)

        def make_args(device):
            state = _serve_state(cfg, B, shape.seq_len, device, mesh)
            return _params(cfg, device, mesh, serve=serve), state, _empty(batch, device, mesh,
                                                                          **seq)

        return {**cell, "fn": make_serve_step(cfg), "make_args": make_args,
                "meta": {"step": "serve_step", "cache_len": shape.seq_len}}

    if shape.kind == "select":
        batch = train_batch_struct(cfg, shape)
        batch.pop("weights")
        # a dense arch's whole mesh serves data parallelism (ZeRO-3 weight
        # gathers cost less than per-layer tensor-parallel reductions in a
        # forward-only program); a MoE keeps expert parallelism
        dp = mesh is not None and cfg.n_experts == 0
        meta = {"step": "select_step"}
        if mesh is not None:
            meta["mode"] = "dp_over_model" if dp else "tp"
        return {**cell, "fn": make_select_step(cfg), "meta": meta, "dp_over_model": dp,
                "make_args": lambda device: (_params(cfg, device, mesh),
                                             _empty(batch, device, mesh, dp_over_model=dp,
                                                    **seq))}
    raise ValueError(shape.kind)


def model_flops(cfg: ModelConfig, shape: ShapeSpec) -> float:
    """Analytic MODEL_FLOPS = 6·N·D (train) / 2·N·D (inference)."""
    n = cfg.active_param_count()
    d = shape.tokens_per_step
    mult = 6.0 if shape.kind == "train" else 2.0
    return mult * n * d


def _card(device: torch.device) -> dict:
    if device.type == "cuda":
        return {"name": torch.cuda.get_device_name(device),
                "memory_bytes": torch.cuda.get_device_properties(device).total_memory}
    return {"name": CARD, "memory_bytes": CARDS[CARD]["memory_bytes"]}


def artifact_path(out_dir: str, arch: str, shape: str, probe: int = 0,
                  mesh_kind: str = MESH) -> str:
    suffix = f"__p{probe}" if probe else ""
    return os.path.join(out_dir, f"{arch}__{shape}__{MESH_TAGS[mesh_kind]}{suffix}.json")


def n_devices(mesh_kind: str) -> int:
    return 1 if mesh_kind == MESH else math.prod(PRODUCTION_MESHES[mesh_kind][0])


def run_cell(arch: str, shape_name: str, mesh_kind: str = MESH, out_dir: str = ARTIFACT_DIR,
             probe: int = 0, device: str = "cuda") -> dict:
    if mesh_kind not in (MESH, *PRODUCTION_MESHES):
        raise ValueError(f"unknown mesh {mesh_kind!r} (want {MESH!r}, 'single' or 'multi')")
    dev = torch.device(device)
    rec: dict = {"arch": arch, "shape": shape_name, "mesh": MESH_TAGS[mesh_kind],
                 "probe": probe, "n_devices": n_devices(mesh_kind), "status": "unknown",
                 "device": str(dev), "card": _card(dev)}
    t0 = time.time()
    try:
        with contextlib.ExitStack() as stack:
            mesh = None
            if mesh_kind != MESH:
                stack.enter_context(fake_world(rec["n_devices"], dev.type))
                mesh = make_production_mesh(multi_pod=mesh_kind == "multi",
                                            device_type=dev.type)
            cell = build_cell(arch, shape_name, probe=probe, mesh=mesh)
            if mesh is not None:
                stack.enter_context(annotate.mesh_context(mesh, cell["dp_over_model"]))
            counts = reckon(cell["fn"], cell["make_args"], dev)
            if mesh is not None:
                # the full depth's too, for a probe: what the device holds
                full = build_cell(arch, shape_name, mesh=mesh) if probe else cell
                counts["memory"]["state_size_in_bytes"] = state_bytes(cell["make_args"], dev)
                counts["memory"]["full_depth_state_size_in_bytes"] = state_bytes(
                    full["make_args"], dev)
        cfg, shape = cell["cfg"], cell["shape"]
        trace = f"one step under FakeTensorMode on {dev.type}, nothing allocated"
        if mesh is not None:
            trace += (f"; DTensors on a fake {rec['mesh']} group, one device's local ops "
                      "counted")
        rec.update(
            status="ok",
            meta=cell["meta"],
            **counts,
            model_flops=model_flops(cfg, shape),
            params=cfg.param_count(),
            active_params=cfg.active_param_count(),
            tokens_per_step=shape.tokens_per_step,
            method={
                "trace": trace,
                "flops": "torch.utils.flop_counter formulas (products; the ce_proxy custom op "
                         "4·T·V·D), split by the operands' dtype",
                "bytes": "Σ over ops that write a tensor of input + output tensor bytes",
                "memory": "arguments + peak of live storages made by the step",
                "scaled": "loops.steps: loops of n trips (keys) traced as three iterations, "
                          "the second counted n − 2 times; values count such loops",
            },
        )
    except SkipCell as e:
        rec.update(status="skip", reason=str(e))
    except Exception as e:  # noqa: BLE001 — record the failure, don't crash the sweep
        tb = traceback.format_exc()
        rec.update(status="error", error=f"{type(e).__name__}: {e}", traceback=tb[-4000:],
                   port_frames=[ln.strip() for ln in tb.splitlines()
                                if "repro_torch" in ln and ln.strip().startswith("File")])
    rec["wall_s"] = round(time.time() - t0, 2)
    os.makedirs(out_dir, exist_ok=True)
    with open(artifact_path(out_dir, arch, shape_name, probe, mesh_kind), "w") as f:
        json.dump(rec, f, indent=1)
    return rec


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.split("\n")[0])
    ap.add_argument("--arch", nargs="+", choices=sorted(ARCHS) + ["all"], default=["all"])
    ap.add_argument("--shape", nargs="+", choices=list(SHAPES) + ["select_pool", "all"],
                    default=["all"])
    ap.add_argument("--all", action="store_true", help="every arch and shape")
    ap.add_argument("--mesh", choices=[MESH, "single", "multi"], default=MESH)
    ap.add_argument("--device", default="cuda", help="device type of the fake tensors")
    ap.add_argument("--out", default=os.path.normpath(ARTIFACT_DIR))
    ap.add_argument("--force", action="store_true", help="recompute existing")
    ap.add_argument("--probes", action="store_true",
                    help="also trace the 1- and 2-period probes")
    ap.add_argument("--probes-only", action="store_true")
    args = ap.parse_args(argv)

    archs = sorted(ARCHS) if args.all or "all" in args.arch else args.arch
    shapes = (list(SHAPES) + ["select_pool"] if args.all or "all" in args.shape
              else args.shape)
    probes = [1, 2] if args.probes_only else ([0, 1, 2] if args.probes else [0])
    failures = 0
    for arch in archs:
        for shape in shapes:
            for probe in probes:
                tag = f"{arch} {shape} {MESH_TAGS[args.mesh]}" + (f"__p{probe}" if probe else "")
                path = artifact_path(args.out, arch, shape, probe, args.mesh)
                if os.path.exists(path) and not args.force:
                    with open(path) as f:
                        prev = json.load(f)
                    if prev.get("status") in ("ok", "skip"):
                        print(f"[cached] {tag}: {prev['status']}", flush=True)
                        continue
                rec = run_cell(arch, shape, args.mesh, args.out, probe, args.device)
                line = f"[{rec['status']:5s}] {tag} wall={rec['wall_s']}s"
                if rec["status"] == "ok":
                    line += (f" flops={rec['cost']['flops']:.4g}"
                             f" bytes={rec['cost']['bytes accessed']:.4g}"
                             f" peak={rec['memory']['peak_bytes'] / 1e9:.2f}GB"
                             f" coll={rec['collective_bytes_total']:.4g}")
                elif rec["status"] == "error":
                    line += f" {rec['error'][:160]}"
                    failures += 1
                print(line, flush=True)
    return 1 if failures else 0


if __name__ == "__main__":
    sys.exit(main())
