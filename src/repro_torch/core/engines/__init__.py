"""Greedy facility-location engines behind the SelectionEngine registry.

Port of ``repro.core.engines``: the shared protocol (``base``), the
registry with the ``engine='auto'`` policy (``registry``), the engines —
matrix, lazy, stochastic, features, device, sparse and streaming — and the
legacy flat-knob shim (``legacy``).  Tree selection's provenance
(``distributed.tree_select.TreeSelectConfig``) restores through
``engine_config_from_dict`` like an engine's.
"""
from repro_torch.core.engines.base import (
    Capabilities,
    EngineConfig,
    FLResult,
    SelectionEngine,
    assign_and_weights,
    cosine_residual_coverage,
    coverage_l,
    facility_location_value,
    normalize_for_metric,
    pairwise_distances,
)
from repro_torch.core.engines.registry import (
    auto_engine_config,
    engine_config_from_dict,
    get_engine,
    list_engines,
    make_engine,
    parse_engine_spec,
    register_engine,
)

# Engine modules self-register on import; matrix first.
from repro_torch.core.engines.matrix import MatrixConfig, MatrixEngine, greedy_fl_matrix
from repro_torch.core.engines.lazy import LazyConfig, LazyEngine, lazy_greedy_fl
from repro_torch.core.engines.stochastic import (
    StochasticConfig,
    StochasticEngine,
    stochastic_greedy_fl,
)
from repro_torch.core.engines.features import (
    FeaturesConfig,
    FeaturesEngine,
    greedy_fl_features,
)
from repro_torch.core.engines.device import DeviceConfig, DeviceEngine, greedy_fl_device
from repro_torch.core.engines.sparse import (
    SparseConfig,
    SparseEngine,
    greedy_fl_topk,
    sparse_greedy_fl,
    sparse_greedy_fl_features,
    topk_graph,
)
from repro_torch.core.engines.streaming import (
    StreamingConfig,
    StreamingEngine,
    StreamingSelector,
    StreamingState,
    ingest_delta,
    init_streaming_state,
    num_sieves,
    streaming_result,
    streaming_result_blocked,
)

__all__ = [
    "Capabilities",
    "EngineConfig",
    "FLResult",
    "SelectionEngine",
    "register_engine",
    "get_engine",
    "list_engines",
    "make_engine",
    "engine_config_from_dict",
    "parse_engine_spec",
    "auto_engine_config",
    "MatrixConfig", "MatrixEngine",
    "LazyConfig", "LazyEngine",
    "StochasticConfig", "StochasticEngine",
    "FeaturesConfig", "FeaturesEngine",
    "DeviceConfig", "DeviceEngine",
    "SparseConfig", "SparseEngine",
    "StreamingConfig", "StreamingEngine", "StreamingSelector", "StreamingState",
    "pairwise_distances",
    "normalize_for_metric",
    "cosine_residual_coverage",
    "coverage_l",
    "facility_location_value",
    "assign_and_weights",
    "greedy_fl_matrix",
    "lazy_greedy_fl",
    "stochastic_greedy_fl",
    "greedy_fl_features",
    "greedy_fl_device",
    "topk_graph",
    "greedy_fl_topk",
    "sparse_greedy_fl",
    "sparse_greedy_fl_features",
    "init_streaming_state",
    "ingest_delta",
    "num_sieves",
    "streaming_result",
    "streaming_result_blocked",
]
