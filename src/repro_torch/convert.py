"""Carry engine configs, selections and weights across from ``repro``.

No counterpart in ``repro``: this module takes the reference package's
outputs as plain numpy arrays and dicts (``EngineConfig.to_dict()``,
``CoresetSelection`` fields, the logistic-regression weight vector, an LM
``init_params`` tree, an optimizer state, an LM serve state; a reference
checkpoint as ``checkpoint.CheckpointManager.restore_reference`` reads
it) and turns them into the port's objects.  It never imports JAX.
"""
from __future__ import annotations

import numpy as np
import torch

from repro_torch._device import resolve_device
from repro_torch.core.craig import CoresetSelection
from repro_torch.core.engines import EngineConfig, engine_config_from_dict
from repro_torch.core.engines.legacy import IMPL_FROM_REFERENCE

__all__ = [
    "IMPL_FROM_REFERENCE",
    "engine_config_from_reference",
    "selection_from_reference",
    "params_from_reference",
    "PROXY_IMPL_FROM_REFERENCE",
    "model_params_from_reference",
    "opt_state_from_reference",
    "serve_state_from_reference",
]

# The reference's select-step proxy heads (``make_select_step(proxy_impl)``).
PROXY_IMPL_FROM_REFERENCE = {"pallas": "cuda", "einsum": "einsum", "auto": "auto"}


def engine_config_from_reference(d: dict) -> EngineConfig:
    """A reference ``EngineConfig.to_dict()`` → the port's typed config.

    ``gains_impl``, the sparse engine's ``impl`` and the streaming
    engine's ``finalize_impl`` map through :data:`IMPL_FROM_REFERENCE`
    ('jax' → 'torch', 'pallas' → 'cuda'); an unknown name raises.  The device
    engine's tiles ``block_n`` and ``block_m`` are dropped: the port's
    kernel streams whole pool columns through blocks of its own width,
    which the plain twin shares.  Every other field carries over
    unchanged.  A tree provenance (``TreeSelectConfig``) converts its
    nested leaf engine the same way.  An unknown engine raises.
    """
    d = dict(d)
    if d.get("name") == "tree" and d.get("local") is not None:
        d["local"] = engine_config_from_reference(d["local"]).to_dict()
    if d.get("name") == "device":
        d.pop("block_n", None)
        d.pop("block_m", None)
    for key in ("gains_impl", "impl", "finalize_impl"):
        if key in d:
            if d[key] not in IMPL_FROM_REFERENCE:
                raise ValueError(f"unknown reference {key} {d[key]!r}")
            d[key] = IMPL_FROM_REFERENCE[d[key]]
    return engine_config_from_dict(d)


def selection_from_reference(
    indices,
    weights,
    *,
    order=None,
    coverage: float = float("nan"),
    epsilon_hat: float | None = None,
    per_class_sizes: dict | None = None,
    engine: dict | None = None,
    n_dropped: int = 0,
) -> CoresetSelection:
    """A reference ``CoresetSelection``'s fields → the port's selection.

    Its ``indices`` (greedy order) serve directly as a port
    ``CraigSelector.select(..., init_selected=...)`` warm start.
    """
    indices = np.asarray(indices, np.int64).ravel()
    weights = np.asarray(weights, np.float32).ravel()
    if indices.shape != weights.shape:
        raise ValueError(
            f"indices {indices.shape} and weights {weights.shape} differ"
        )
    return CoresetSelection(
        indices=indices,
        weights=weights,
        order=np.arange(len(indices)) if order is None else np.asarray(order),
        coverage=float(coverage),
        epsilon_hat=float(coverage if epsilon_hat is None else epsilon_hat),
        per_class_sizes=None if per_class_sizes is None else dict(per_class_sizes),
        engine=None if engine is None else engine_config_from_reference(engine).to_dict(),
        n_dropped=int(n_dropped),
    )


def params_from_reference(w, device: str | torch.device = "cuda") -> torch.Tensor:
    """The logistic-regression weight vector (d,) → an fp32 tensor on
    ``device`` (the card unless the caller asks for the CPU)."""
    w = np.array(w, np.float32)  # a writable copy
    if w.ndim != 1:
        raise ValueError(f"expected a (d,) weight vector, got shape {w.shape}")
    return torch.from_numpy(w).to(resolve_device(device))


def _flat_names(tree: dict, prefix: str = "") -> dict:
    out = {}
    for k, v in tree.items():
        name = f"{prefix}{k}"
        if isinstance(v, dict):
            out.update(_flat_names(v, name + "."))
        else:
            out[name] = v
    return out


def _unstack_layers(stack: dict, period: int) -> list:
    """A reference ``{'scanned': per-kind trees stacked over the periods |
    None, 'remainder': [tree]}`` → one flat {name: array} per layer, in
    layer order."""
    layers: list[dict] = []
    scanned = stack["scanned"]
    if scanned is not None:
        n_full = np.shape(next(iter(_flat_names(scanned[0]).values())))[0]
        for j in range(n_full):
            for i in range(period):
                layers.append({k: np.asarray(v)[j] for k, v in _flat_names(scanned[i]).items()})
    layers.extend(_flat_names(p) for p in stack["remainder"])
    return layers


def model_params_from_reference(tree: dict, cfg, device: str | torch.device = "cuda") -> dict:
    """A reference ``models.init_params`` tree (leaves as numpy arrays) →
    the port's flat fp32 parameter dict on ``device``.

    The stacked ``stack.scanned`` periods (leading axis = period index)
    and the ``stack.remainder`` list become ``layers.<i>.*`` in layer
    order; nested dicts become dotted names; attention weights keep their
    (d, H, hd) / (H, hd, d) layouts, MoE experts their (E, …) ones,
    Griffin blocks their ``w_x`` … ``b_i``, mLSTM cells their ``w_up``,
    ``w_down``, ``conv``, ``wq``/``wk``/``wv`` (di, H, d), ``w_if``,
    ``b_if``, ``skip_scale``, ``out_norm.scale`` and sLSTM cells their
    ``w_in``, ``r_in`` (4, H, d, d), ``b``, ``w_down``, ``out_norm.scale``
    as they are; the (d, padded_vocab) ``unembed`` is transposed to the
    port's vocab-major (padded_vocab, d), the codebook heads' (C, d,
    padded_vocab) to (C, padded_vocab, d).  The embeddings frontend has no
    ``embed``.  Raises ``ValueError`` when a parameter of
    ``models.param_shapes(cfg)`` is missing, when the tree holds one that
    is not there, or when a shape differs.
    """
    from repro_torch.models import param_shapes

    dev = resolve_device(device)
    # a checkpoint read back leaves out what the reference's tree held as
    # None (no full period) or an empty list (no remainder)
    stack = {"scanned": None, "remainder": [], **tree["stack"]}
    layers = _unstack_layers(stack, len(cfg.block_pattern))
    if len(layers) != cfg.n_layers:
        raise ValueError(f"tree holds {len(layers)} layers, config has {cfg.n_layers}")
    out = {}
    for i, layer in enumerate(layers):
        for k, v in layer.items():
            out[f"layers.{i}.{k}"] = v
    if "embed" in tree:
        out["embed"] = tree["embed"]
    out["final_norm.scale"] = tree["final_norm"]["scale"]
    if "unembed" in tree:
        out["unembed"] = np.swapaxes(np.asarray(tree["unembed"]), -1, -2)
    want = param_shapes(cfg)
    missing, extra = sorted(set(want) - set(out)), sorted(set(out) - set(want))
    if missing or extra:
        raise ValueError(f"reference tree for {cfg.name}: missing {missing}, extra {extra}")
    bad = {k: (np.shape(v), want[k]) for k, v in out.items() if np.shape(v) != want[k]}
    if bad:
        raise ValueError(f"reference tree for {cfg.name}: shapes (got, want) {bad}")
    return {
        k: torch.from_numpy(np.array(v, np.float32)).to(dev) for k, v in out.items()
    }


def opt_state_from_reference(state, cfg, device: str | torch.device = "cuda"):
    """A reference ``OptState(step, inner)`` of an LM's parameters, as nested
    dicts of numpy arrays (``{'step': (), 'inner': ...}``) or a NamedTuple
    → the port's ``optim.OptState``: AdamW's ``{'m': tree, 'v': tree}`` and
    momentum's tree ``m`` become flat fp32 dicts on ``device`` as
    :func:`model_params_from_reference` makes them; SGD's empty state
    stays empty."""
    from repro_torch.optim.optimizers import OptState

    if not isinstance(state, dict):  # the reference's NamedTuple itself
        state = {"step": state.step, "inner": state.inner}
    inner = state.get("inner") or {}
    if "stack" in inner:  # momentum: the trace is a parameter tree
        inner = {"m": inner}
    return OptState(int(np.asarray(state["step"])),
                    {k: model_params_from_reference(v, cfg, device) for k, v in inner.items()})


_SLSTM_STATE = ("c", "n", "h", "m")  # the reference's tuple order
_STATE_KEYS = {"rglru": {"h", "conv"}, "mlstm": {"C", "n", "m", "conv"},
               "slstm": set(_SLSTM_STATE)}


def _named_slstm_states(stack: dict, cfg) -> dict:
    """The reference's per-layer states with each sLSTM tuple (c, n, h, m)
    made a dict of those names."""
    period = cfg.block_pattern

    def named(kind, s):
        if kind == "slstm" and isinstance(s, (tuple, list)):
            return dict(zip(_SLSTM_STATE, s))
        return s

    scanned = stack["scanned"]
    if scanned is not None:
        scanned = tuple(named(k, s) for k, s in zip(period, scanned))
    remainder = [named(period[i % len(period)], s) for i, s in enumerate(stack["remainder"])]
    return {"scanned": scanned, "remainder": remainder}


def serve_state_from_reference(state: dict, cfg, device: str | torch.device = "cuda") -> dict:
    """A reference ``init_serve_state``/``decode_step`` state (leaves as
    numpy arrays) → the port's ``{'layers': [per-layer state], 'pos': int}``
    on ``device``.

    The stacked periods are unstacked and the remainder appended, in layer
    order; KV caches {k, v} stay bf16 (exact through fp32), Griffin states
    keep {h, conv}, mLSTM states {C, n, m, conv}, all with their dtypes;
    an sLSTM state, the reference's tuple (c, n, h, m), becomes the dict
    of those names.  Raises ``ValueError`` when the layer count or a
    layer's keys do not fit ``cfg``."""
    dev = resolve_device(device)
    layers = _unstack_layers(_named_slstm_states(state["layers"], cfg), len(cfg.block_pattern))
    if len(layers) != cfg.n_layers:
        raise ValueError(f"state holds {len(layers)} layers, config has {cfg.n_layers}")
    out = []
    for i, (kind, layer) in enumerate(zip(cfg.layer_kinds, layers)):
        want = _STATE_KEYS.get(kind, {"k", "v"})
        if set(layer) != want:
            raise ValueError(f"layer {i} ({kind}): state keys {sorted(layer)}, want {sorted(want)}")
        out.append({
            k: torch.from_numpy(np.array(v, np.float32)).to(
                dev, torch.bfloat16 if "bfloat16" in str(np.asarray(v).dtype) else torch.float32)
            for k, v in layer.items()
        })
    return {"layers": out, "pos": int(np.asarray(state["pos"]))}
