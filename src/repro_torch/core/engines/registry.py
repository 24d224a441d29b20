"""Engine registry and the ``engine='auto'`` policy.

Port of ``repro.core.engines.registry``.  ``register_engine`` publishes an
engine; everything else goes through ``get_engine``/``list_engines``/
``make_engine``.  ``auto_engine_config`` picks the engine from the pool
size and the backend: the CUDA backend takes the reference's TPU row (the
``device`` engine, one fused ``fl_gains_argmax`` sweep per round), and
pools past 2·10⁵ points go to the ``sparse`` engine on every backend.
"""
from __future__ import annotations

import torch

from repro_torch.core.engines.base import EngineConfig, SelectionEngine

__all__ = [
    "register_engine",
    "get_engine",
    "list_engines",
    "make_engine",
    "engine_config_from_dict",
    "parse_engine_spec",
    "auto_engine_config",
    "DENSE_MAX_N",
    "SPARSE_MIN_N",
    "NOT_PORTED",
]

_REGISTRY: dict[str, type[SelectionEngine]] = {}

# Engines of the reference that this package does not have yet, with the
# ROADMAP item that ports them (none left).
NOT_PORTED: dict[str, str] = {}


def register_engine(cls: type[SelectionEngine]) -> type[SelectionEngine]:
    """Class decorator: publish a SelectionEngine under ``cls.name``."""
    for attr in ("name", "config_cls", "capabilities"):
        if not hasattr(cls, attr):
            raise TypeError(f"engine {cls.__name__} is missing {attr!r}")
    if cls.name in _REGISTRY:
        raise ValueError(f"engine {cls.name!r} already registered")
    if cls.config_cls.name != cls.name:
        raise ValueError(
            f"engine {cls.name!r} has a config named {cls.config_cls.name!r}"
        )
    _REGISTRY[cls.name] = cls
    return cls


def get_engine(name: str) -> type[SelectionEngine]:
    """Engine class for ``name``; raises with the registered set."""
    try:
        return _REGISTRY[name]
    except KeyError:
        if name in NOT_PORTED:
            raise ValueError(
                f"engine {name!r} is not ported to repro_torch yet "
                f"({NOT_PORTED[name]}); registered engines: "
                f"{', '.join(_REGISTRY)}"
            ) from None
        raise ValueError(
            f"unknown engine {name!r}; registered engines: "
            f"{', '.join(_REGISTRY)}"
        ) from None


def list_engines() -> tuple[str, ...]:
    """Registered engine names, in registration order (matrix first)."""
    return tuple(_REGISTRY)


def make_engine(config: EngineConfig) -> SelectionEngine:
    """Instantiate the engine a typed config names."""
    return get_engine(config.name)(config)


def engine_config_from_dict(d: dict) -> EngineConfig:
    """Inverse of ``EngineConfig.to_dict`` — restores the typed config.

    ``name == 'tree'`` restores a ``TreeSelectConfig``: tree selection
    orchestrates the round-1 engines and is no registered engine, but its
    provenance rides the same paths (imported here, since the tree module
    imports the engines)."""
    d = dict(d)
    try:
        name = d.pop("name")
    except KeyError:
        raise ValueError(f"engine config dict has no 'name': {d!r}") from None
    if name == "tree":
        from repro_torch.distributed.tree_select import TreeSelectConfig

        return TreeSelectConfig(**{**d, "fanouts": tuple(d["fanouts"])})
    return get_engine(name).config_cls(**d)


def parse_engine_spec(spec: str) -> EngineConfig:
    """CLI-style engine spec → typed config.

    ``'matrix'`` → ``MatrixConfig()``; ``'device:q=16,stale_tol=0.8'`` →
    ``DeviceConfig(q=16, stale_tol=0.8)``.  Values are coerced int → float
    → str.
    """
    name, _, args = spec.partition(":")
    cfg_cls = get_engine(name.strip()).config_cls
    kw = {}
    for item in filter(None, (s.strip() for s in args.split(","))):
        key, sep, val = item.partition("=")
        if not sep:
            raise ValueError(
                f"bad engine spec item {item!r} in {spec!r} (want key=value)"
            )
        kw[key.strip()] = _coerce(val.strip())
    return cfg_cls(**kw)


def _coerce(v: str):
    for cast in (int, float):
        try:
            return cast(v)
        except ValueError:
            continue
    return v


DENSE_MAX_N = 20_000  # largest pool the dense (n, n) engines handle comfortably
SPARSE_MIN_N = 200_000  # past this, only O(n·k) memory is acceptable


def auto_engine_config(
    n: int, *, backend: str | None = None, mode: str = "budget"
) -> EngineConfig:
    """The ``engine='auto'`` policy.

    ======================  =========================================
    situation               chosen engine
    ======================  =========================================
    mode='cover'            matrix — the only cover-capable engine
    n ≤ 20 000              matrix — dense exact greedy fits
    20 000 < n ≤ 200 000    device on CUDA (fused ``fl_gains_argmax``
                            sweeps), features elsewhere
    n > 200 000             sparse (the ``topk_sim`` graph on a card)
    ======================  =========================================

    Args:
      n: pool size the selection will run over.
      backend: 'cuda' | 'cpu'; defaults to 'cuda' when a card is present.
      mode: 'budget' | 'cover' (cover forces the matrix engine).
    """
    if backend is None:
        backend = "cuda" if torch.cuda.is_available() else "cpu"
    if mode == "cover" or n <= DENSE_MAX_N:
        name = "matrix"
    elif n <= SPARSE_MIN_N:
        name = "device" if backend == "cuda" else "features"
    else:
        name = "sparse"
    return get_engine(name).config_cls()
