"""Compatibility façade over ``repro_torch.core.engines``.

Port of ``repro.core.facility_location``: the functional API of the greedy
facility-location maximizers, re-exported under the reference's names so
that ``from repro_torch.core import facility_location as fl`` reads as the
reference's module does.  New code should prefer the typed surface of
``repro_torch.core.engines`` (``EngineConfig`` subclasses,
``get_engine``/``list_engines``, ``CraigConfig(engine=SparseConfig(k=64))``).
"""
from repro_torch.core.engines.base import (
    FLResult,
    assign_and_weights,
    coverage_l,
    facility_location_value,
)
from repro_torch.core.engines.device import greedy_fl_device
from repro_torch.core.engines.features import greedy_fl_features
from repro_torch.core.engines.lazy import lazy_greedy_fl
from repro_torch.core.engines.matrix import greedy_fl_matrix
from repro_torch.core.engines.sparse import (
    greedy_fl_topk,
    sparse_greedy_fl,
    sparse_greedy_fl_features,
    topk_graph,
)
from repro_torch.core.engines.stochastic import stochastic_greedy_fl
from repro_torch.core.engines.streaming import (
    StreamingState,
    init_streaming_state,
    ingest_delta,
    streaming_result,
)

__all__ = [
    "FLResult",
    "facility_location_value",
    "coverage_l",
    "greedy_fl_matrix",
    "lazy_greedy_fl",
    "stochastic_greedy_fl",
    "greedy_fl_features",
    "greedy_fl_device",
    "topk_graph",
    "greedy_fl_topk",
    "sparse_greedy_fl",
    "sparse_greedy_fl_features",
    "assign_and_weights",
    "StreamingState",
    "init_streaming_state",
    "ingest_delta",
    "streaming_result",
]
