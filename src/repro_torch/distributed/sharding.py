"""Sharding rules: parameter names → per-dimension mesh axes, and DTensor
placements.

Port of ``repro.distributed.sharding``.  Mesh axes (``launch/mesh.py``):

  single-pod:  ("data", "model")           = (16, 16)
  multi-pod:   ("pod", "data", "model")    = (2, 16, 16)

Policy, the reference's:

  * 2-D "fsdp × tensor" parameter sharding: the d_model-like dimension of
    every large matrix shards over ``data`` (ZeRO-3), the ffn/head/vocab/
    expert dimension over ``model`` (tensor/expert parallelism);
  * ``pod`` is pure data parallelism: parameters replicate across pods,
    gradients reduce over (pod, data);
  * activations: batch over (pod, data); a batch too small for the data
    axes shards its sequence instead (``batch_specs``' ``seq_shard``);
  * optimizer state shards exactly like its parameter.

A spec is the reference's ``PartitionSpec`` as plain data: a tuple with
one entry per tensor dim, each ``None`` (replicated), an axis name, or a
tuple of names (the dim split over those axes, major first).  Rules are
(regex, spec) pairs matched in order against the parameter's name with
its dots as slashes (``layers.3.mixer.wq`` → ``layers/3/mixer/wq``); the
first full match wins.  A spec needs only the mesh's axis names and
sizes, so ``mesh`` is anything with ``axis_names`` and ``shape`` (a dict
of axis → size, or the sizes in axis order): ``launch/mesh.py::Mesh``, a
``DeviceMesh``, or a stand-in.  :func:`to_placements` then turns a spec
into DTensor placements on a ``DeviceMesh``.

Where the port's layouts differ from the reference's:

  * the port keeps one tensor a layer, with no stacked leading axis, so
    the reference's rank alignment for stacked leaves drops out (a spec
    shorter than its tensor still gains leading ``None``s, as a 1-D rule
    on a norm scale does in both packages);
  * the port stores ``unembed`` vocab-major, (V, D), and the codebook
    heads as (C, V, D): their rules are the reference's transposed, (D,
    V) ``P(data, model)`` becoming ``("model", "data")``.
"""
from __future__ import annotations

import math
import re
__all__ = [
    "param_specs",
    "param_shardings",
    "batch_specs",
    "state_shardings",
    "serve_param_specs",
    "serve_state_specs",
    "logical_to_sharding",
    "mesh_shape",
    "to_placements",
]

# dimension-name → mesh-axis mapping
_FSDP = "data"  # ZeRO-3 axis
_TP = "model"  # tensor/expert axis

# (regex over the slash-joined name, spec).  Order matters: the first full
# match wins (unembed before embed).
_RULES: list[tuple[str, tuple]] = [
    # unembedding, vocab-major (V, D) [(C, V, D) rank-aligns]: the
    # reference's (D, V) P(data, model) transposed
    (r".*unembed$", (_TP, _FSDP)),
    # embedding: vocab replicated — a vocab-sharded gather forces a full
    # rematerialization; d_model over both axes instead
    (r".*embed$", (None, (_FSDP, _TP))),  # (V, D)
    # attention
    (r".*mixer/wq$", (_FSDP, _TP, None)),  # (D, H, hd)
    (r".*mixer/wk$", (_FSDP, _TP, None)),
    (r".*mixer/wv$", (_FSDP, _TP, None)),
    (r".*mixer/wo$", (_TP, None, _FSDP)),  # (H, hd, D)
    (r".*mixer/b[qkv]$", (_TP, None)),  # (H, hd)
    # griffin / rg-lru
    (r".*mixer/w_(x|gate)$", (_FSDP, _TP)),  # (D, R)
    (r".*mixer/w_out$", (_TP, _FSDP)),  # (R, D)
    (r".*mixer/w_(a|i)$", (_TP, None)),  # (R, R) diag-ish gates
    (r".*mixer/conv$", (None, _TP)),  # (K, R)
    (r".*mixer/(lam|b_a|b_i)$", (_TP,)),  # (R,)
    # mlstm / slstm
    (r".*mixer/w_up$", (_FSDP, _TP)),
    (r".*mixer/w_down$", (_TP, _FSDP)),
    # (di, H, hd) — unreachable for wq/wk/wv, which the attention rules
    # above take first, as in the reference
    (r".*mixer/w(q|k|v)$", (_TP, None, None)),
    (r".*mixer/w_if$", (_TP, None)),
    (r".*mixer/w_in$", (_FSDP, _TP)),  # slstm (D, 4di)
    (r".*mixer/r_in$", (None, None, _TP, None)),  # (4, H, hd, hd) — hd over model
    (r".*mixer/(skip_scale|b)$", (_TP,)),
    # MoE: experts over model, fsdp over the d_model dim
    (r".*ffn/router$", (_FSDP, None)),  # (D, E) — small
    (r".*ffn/experts_in$", (_TP, _FSDP, None)),  # (E, D, F)
    (r".*ffn/experts_out$", (_TP, None, _FSDP)),  # (E, F, D)
    (r".*ffn/shared_in$", (_FSDP, _TP)),
    (r".*ffn/shared_out$", (_TP, _FSDP)),
    # dense FFN
    (r".*ffn/w_in$", (_FSDP, _TP)),  # (D, 2F)
    (r".*ffn/w_out$", (_TP, _FSDP)),  # (F, D)
    # norms and anything 1-D: replicate
    (r".*scale$", ()),
    (r".*", ()),
]


def mesh_shape(mesh) -> dict[str, int]:
    """Axis name → size, in axis order, of a mesh: a ``DeviceMesh`` (sizes in
    dim order), or anything with ``axis_names`` and a ``shape`` dict."""
    if isinstance(mesh.shape, dict):
        return dict(mesh.shape)
    return dict(zip(mesh.mesh_dim_names, (int(s) for s in mesh.shape)))


def _group(a) -> tuple:
    return a if isinstance(a, tuple) else (a,) if a is not None else ()


def _entry(group: tuple):
    return group if len(group) > 1 else (group[0] if group else None)


def _filter_spec(spec: tuple, mesh, ndim: int, shape=None) -> tuple:
    """Drop axes the mesh lacks; pad to the tensor's rank; drop
    non-divisible shardings.

    Placed arguments need exact divisibility (unlike activation
    constraints, which shard unevenly), so non-divisible dims replicate.
    A rule with more axes than the tensor is a mismatch: replicate.
    """
    axes = list(spec)
    if len(axes) > ndim:
        return (None,) * ndim
    axes = [None] * (ndim - len(axes)) + axes
    sizes = mesh_shape(mesh)
    out = []
    for i, a in enumerate(axes):
        group = tuple(g for g in _group(a) if g in sizes)
        if group and shape is not None:
            if shape[i] % math.prod(sizes[g] for g in group) != 0:
                group = ()  # non-divisible: replicate this dim
        out.append(_entry(group))
    return tuple(out)


def _spec_for(name: str, shape, mesh) -> tuple:
    path = name.replace(".", "/")
    for pat, spec in _RULES:
        if re.fullmatch(pat, path):
            return _filter_spec(spec, mesh, len(shape), tuple(shape))
    return (None,) * len(shape)


def param_specs(params: dict, mesh) -> dict:
    """{name: spec} for a flat parameter dict (tensors, or shapes)."""
    return {k: _spec_for(k, tuple(getattr(v, "shape", v)), mesh) for k, v in params.items()}


def to_placements(spec: tuple, mesh) -> tuple:
    """A spec → DTensor placements, one per mesh dim: ``Shard(d)`` on every
    mesh dim that tensor dim ``d`` is split over, ``Replicate()`` on the
    others.  A dim over several axes takes them in mesh order (major
    first), as the spec lists them.  An axis of size 1 splits nothing and
    stays ``Replicate()`` (DTensor would refuse reshapes of a dim split
    one way)."""
    from torch.distributed.tensor import Replicate, Shard

    sizes = mesh_shape(mesh)
    names = tuple(sizes)
    out = [Replicate()] * len(names)
    for d, a in enumerate(spec):
        group = _group(a)
        idx = [names.index(g) for g in group]
        if idx != sorted(idx):
            raise ValueError(f"spec entry {a!r} lists axes out of the mesh's order {names}")
        for i in idx:
            if sizes[names[i]] > 1:
                out[i] = Shard(d)
    return tuple(out)


def logical_to_sharding(mesh, spec: tuple) -> tuple:
    """The reference's ``NamedSharding(mesh, spec)``: the spec's placements."""
    return to_placements(spec, mesh)


def param_shardings(params: dict, mesh) -> dict:
    """{name: placements} for ``params`` on a ``DeviceMesh``."""
    return {k: to_placements(s, mesh) for k, s in param_specs(params, mesh).items()}


def serve_param_specs(params: dict, mesh) -> dict:
    """Inference-time parameter specs: tensor/expert sharding only, no
    ZeRO-3.

    At serve time there is no optimizer state, so per-layer FSDP weight
    all-gathers would be pure overhead on the decode critical path: the
    ``data`` axis leaves every spec — weights replicate across
    data-parallel replicas, and a device holds params_bytes/|model|.
    """
    def strip(spec):
        return tuple(_entry(tuple(g for g in _group(a) if g != _FSDP)) for a in spec)

    return {k: strip(s) for k, s in param_specs(params, mesh).items()}


def state_shardings(opt_state, params_specs: dict, mesh):
    """Optimizer state shards like its parameter; the step replicates.

    Returns the ``OptState`` shape with specs in place of tensors: the
    step's spec is ``()`` (a host integer in the port), AdamW's ``m`` and
    ``v`` (and momentum's ``m``) each ``params_specs``, SGD's empty
    state empty."""
    from repro_torch.optim.optimizers import OptState

    return OptState((), {k: dict(params_specs) for k in opt_state.inner})


def batch_specs(mesh, batch_shape_tree: dict, seq_shard: bool = False,
                dp_over_model: bool = False) -> dict:
    """Input batch specs: the batch dim over (pod, data) — plus ``model``
    in ``dp_over_model`` mode (forward-only throughput programs);
    optionally the sequence dim over ``data`` instead (long-context,
    batch-1 cells).  ``batch_shape_tree`` maps a name to a tensor or a
    shape."""
    sizes = mesh_shape(mesh)
    dp_names = ("pod", "data", "model") if dp_over_model else ("pod", "data")
    dp = tuple(a for a in dp_names if a in sizes)
    dp_size = math.prod(sizes[a] for a in dp)

    def one(name, arr):
        shape = tuple(getattr(arr, "shape", arr))
        ndim, b = len(shape), shape[0]
        if name == "weights":
            return (_entry(dp) if b % dp_size == 0 else None,)
        if b % dp_size != 0:
            # batch not shardable (long_500k batch 1): shard the sequence
            if seq_shard and ndim >= 2 and shape[1] % sizes.get("data", 1) == 0:
                return (None, "data") + (None,) * (ndim - 2)
            # the greedy prefix of the dp axes whose running product divides b
            dp_fit: list = []
            prod = 1
            for a in dp:
                if b % (prod * sizes[a]) == 0:
                    dp_fit.append(a)
                    prod *= sizes[a]
            return (_entry(tuple(dp_fit)),) + (None,) * (ndim - 1)
        return (_entry(dp),) + (None,) * (ndim - 1)

    return {k: one(k, v) for k, v in batch_shape_tree.items()}


def serve_state_specs(state_tree, mesh, batch: int):
    """Specs of decode caches and recurrent states (shape-driven).

    Per tensor:
      * the first dim whose size is ``batch`` shards over (pod, data) when
        divisible (synchronized batched decode);
      * the *last* remaining divisible dim shards over ``model`` — head_dim
        of a KV cache, the value dim of an mLSTM memory, the recurrence
        width of an RG-LRU state.  The sequence dim stays whole: a per-step
        cache write into a sharded sequence dim gathers the cache every
        layer, where a contraction-dim shard keeps the write local and
        costs a small partial-sum reduction of the scores;
      * if the batch dim could not shard (long_500k batch 1), the largest
        remaining divisible dim takes ``data`` as well.

    ``state_tree`` is any nesting of dicts, lists and tuples over tensors;
    the result has its shape with a spec at each tensor, and what is not a
    tensor (the port's ``pos``, a host integer) is left as it is.
    """
    sizes = mesh_shape(mesh)
    dp = tuple(a for a in ("pod", "data") if a in sizes)
    dp_size = math.prod(sizes[a] for a in dp) if dp else 1
    tp_size = sizes.get(_TP, 1)
    data_size = sizes.get("data", 1)

    def one(shape):
        ndim = len(shape)
        axes: list = [None] * ndim
        used = set()
        b_dim = None
        for i, s in enumerate(shape):
            if s == batch and batch % dp_size == 0 and batch >= dp_size:
                axes[i] = _entry(dp)
                b_dim = i
                used.add(i)
                break
        cand = [i for i in range(ndim)
                if i not in used and shape[i] % tp_size == 0 and shape[i] >= tp_size]
        if cand and tp_size > 1:
            mi = cand[-1]
            axes[mi] = _TP
            used.add(mi)
        if b_dim is None and data_size > 1:
            cand = [(shape[i], i) for i in range(ndim)
                    if i not in used and shape[i] % data_size == 0 and shape[i] >= data_size]
            if cand:
                _, di = max(cand)
                axes[di] = "data"
        return tuple(axes)

    def walk(node):
        if isinstance(node, dict):
            return {k: walk(v) for k, v in node.items()}
        if isinstance(node, (list, tuple)):
            return type(node)(walk(v) for v in node)
        if hasattr(node, "shape"):
            return one(tuple(node.shape))
        return node

    return walk(state_tree)
