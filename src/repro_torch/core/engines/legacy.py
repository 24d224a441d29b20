"""Deprecation shim for the pre-registry flat engine-knob surface.

Port of ``repro.core.engines.legacy`` (``LegacyEngineKnobs``,
``resolve_engine_config``).  The reference's flat knobs hang off
``CraigConfig`` as engine-prefixed fields; this module maps them onto the
typed ``EngineConfig``s with one ``DeprecationWarning`` per resolution::

    engine='sparse', topk_k=64, topk_impl='cuda'
        -> engine=SparseConfig(k=64, impl='cuda')
    engine='device', device_q=16, device_stale_tol=0.8,
                     device_tile_dtype='bfloat16'
        -> engine=DeviceConfig(q=16, stale_tol=0.8, tile_dtype='bfloat16')
    engine='features', gains_impl='cuda'
        -> engine=FeaturesConfig(gains_impl='cuda')
    engine='stochastic', stochastic_delta=0.05
        -> engine=StochasticConfig(delta=0.05)
    engine='matrix' / 'lazy'
        -> engine=MatrixConfig() / LazyConfig()

Implementation names: the reference's knobs default to ``'jax'``, which
here would pick the plain twin on a card; the port's default to
``'auto'``.  Both packages' names are accepted and mapped through
:data:`IMPL_FROM_REFERENCE` ('jax' → 'torch', 'pallas' → 'cuda').

The repository's linter allows the flat knob names only in the
reference's shim, so each line of this module that names one carries its
own suppression.
"""
from __future__ import annotations

import dataclasses
import warnings

from repro_torch.core.engines.base import EngineConfig
from repro_torch.core.engines.registry import get_engine

__all__ = [
    "IMPL_FROM_REFERENCE",
    "LegacyEngineKnobs",
    "resolve_distributed_engine",
    "resolve_engine_config",
]

# The reference's kernel routes (``FeaturesConfig.gains_impl``,
# ``SparseConfig.impl``, ``StreamingConfig.finalize_impl``) and their
# counterparts here.  The port's own names map to themselves.
IMPL_FROM_REFERENCE = {"jax": "torch", "pallas": "cuda", "auto": "auto", "dense": "dense",
                       "torch": "torch", "cuda": "cuda"}

_LEGACY_ENGINE_STRINGS = (
    "matrix", "lazy", "stochastic", "features", "sparse", "device",
)


@dataclasses.dataclass(frozen=True, kw_only=True)
class LegacyEngineKnobs:
    """Deprecated flat engine knobs, inherited by ``CraigConfig``.

    :func:`resolve_engine_config` is their only reader.  kw_only, so that
    inheriting them leaves ``CraigConfig``'s positional order alone.
    """

    stochastic_delta: float = 0.01
    gains_impl: str = "auto"
    topk_k: int = 64  # repro-lint: disable=flat-engine-knob  # the shim's own field
    topk_impl: str = "auto"
    device_q: int = 1  # repro-lint: disable=flat-engine-knob  # the shim's own field
    device_stale_tol: float = 0.7  # repro-lint: disable=flat-engine-knob  # the shim's own field
    device_tile_dtype: str = "float32"


def _impl(name: str) -> str:
    try:
        return IMPL_FROM_REFERENCE[name]
    except KeyError:
        raise ValueError(f"unknown implementation name {name!r}") from None


def _map_legacy_string(cfg, engine: str) -> EngineConfig:
    """Legacy engine string + flat knobs → the equivalent typed config."""
    cfg_cls = get_engine(engine).config_cls
    if engine == "stochastic":
        return cfg_cls(delta=cfg.stochastic_delta)
    if engine == "features":
        return cfg_cls(gains_impl=_impl(cfg.gains_impl))
    if engine == "sparse":
        k = cfg.topk_k  # repro-lint: disable=flat-engine-knob  # the shim maps the knob
        return cfg_cls(k=k, impl=_impl(cfg.topk_impl))
    if engine == "device":
        q = cfg.device_q  # repro-lint: disable=flat-engine-knob  # the shim maps the knob
        tol = cfg.device_stale_tol  # repro-lint: disable=flat-engine-knob  # the shim maps the knob
        return cfg_cls(q=q, stale_tol=tol, tile_dtype=cfg.device_tile_dtype,
                       gains_impl=_impl(cfg.gains_impl))
    return cfg_cls()  # matrix / lazy — no knobs


def _nondefault_knobs(cfg) -> dict:
    """Flat knobs whose value differs from the LegacyEngineKnobs default."""
    return {
        f.name: getattr(cfg, f.name)
        for f in dataclasses.fields(LegacyEngineKnobs)
        if getattr(cfg, f.name) != f.default
    }


def resolve_engine_config(cfg, _stacklevel: int = 3) -> EngineConfig | None:
    """``CraigConfig.engine`` (str | EngineConfig) → typed EngineConfig.

    Returns None for ``'auto'`` — the caller resolves per pool via
    ``registry.auto_engine_config``.  Legacy strings map the flat knobs
    onto the typed config and emit one ``DeprecationWarning``.  Flat knobs
    combined with a typed config or ``'auto'`` have nothing to attach to;
    they are ignored with a ``UserWarning``.  ``_stacklevel`` points the
    warnings at the user's call site.
    """
    engine = cfg.engine
    if isinstance(engine, EngineConfig) or engine == "auto":
        stray = _nondefault_knobs(cfg)
        if stray:
            warnings.warn(
                f"CraigConfig(engine={engine!r}) ignores the legacy flat "
                f"engine knobs {stray} — set them on the typed EngineConfig "
                "instead",
                UserWarning,
                stacklevel=_stacklevel,
            )
        return engine if isinstance(engine, EngineConfig) else None
    if engine not in _LEGACY_ENGINE_STRINGS:
        raise ValueError(
            f"unknown engine {engine!r}: pass an EngineConfig, 'auto', or "
            f"one of {_LEGACY_ENGINE_STRINGS}"
        )
    typed = _map_legacy_string(cfg, engine)
    warnings.warn(
        f"CraigConfig(engine={engine!r}) with flat engine knobs is "
        f"deprecated; use CraigConfig(engine={typed!r})",
        DeprecationWarning,
        stacklevel=_stacklevel,
    )
    return typed


_DISTRIBUTED_KNOBS = ("topk_k", "device_q", "device_stale_tol")


def resolve_distributed_engine(local_engine, knobs: dict) -> EngineConfig | None:
    """``distributed_select``'s legacy flat-kwarg surface → typed config.

    ``local_engine`` is a typed EngineConfig, ``'auto'`` (returns None —
    the caller resolves per shard via ``auto_engine_config``), or a legacy
    string combined with flat knob kwargs collected in ``knobs``.  The
    kernel routes keep their 'auto' default, which
    ``core.distributed.normalize_round1_config`` resolves on the shard's
    device.
    """
    unknown = set(knobs) - set(_DISTRIBUTED_KNOBS)
    if unknown:
        raise TypeError(
            f"distributed_select got unexpected kwargs {sorted(unknown)}"
        )
    if isinstance(local_engine, EngineConfig):
        if knobs:
            raise TypeError(
                "pass either a typed EngineConfig or legacy flat engine "
                "kwargs, not both"
            )
        return local_engine
    if local_engine == "auto":
        if knobs:
            raise TypeError(
                "legacy flat engine kwargs require a legacy local_engine "
                "string; with local_engine='auto' pass a typed EngineConfig"
            )
        return None
    if local_engine not in _LEGACY_ENGINE_STRINGS:
        raise ValueError(f"unknown local_engine {local_engine!r}")
    cfg_cls = get_engine(local_engine).config_cls
    if local_engine == "sparse":
        typed = cfg_cls(k=knobs.get("topk_k", 64))
    elif local_engine == "device":
        typed = cfg_cls(
            q=knobs.get("device_q", 1),
            stale_tol=knobs.get("device_stale_tol", 0.7),
        )
    else:
        typed = cfg_cls()
    warnings.warn(
        f"distributed_select(local_engine={local_engine!r}, ...) with flat "
        f"engine kwargs is deprecated; pass local_engine={typed!r}",
        DeprecationWarning,
        stacklevel=3,
    )
    return typed
