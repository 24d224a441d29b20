"""Device-resident fused greedy engine.

Port of ``repro.core.engines.device``.  A sweep round is one fused
gains + per-block argmax pass over every candidate — on a card a single
launch of the hand-written ``fl_gains_argmax`` CUDA kernel, on the CPU its
plain-torch twin — and commits the winner.  ``q > 1`` amortizes each
sweep over up to q commits through Minoux upper bounds.

The reference's ``lax.while_loop`` becomes a Python loop.  At ``q=1`` the
winner never leaves the device (``index_select``/``index_fill_``), so a
selection makes no host round trip per round.  The ``q > 1`` lazy path
needs one host read per lazy round for its commit decision.
"""
from __future__ import annotations

import dataclasses
from typing import ClassVar

import torch

from repro_torch.core.engines.base import (
    Capabilities,
    EngineConfig,
    FLResult,
    SelectionEngine,
    _replay_prefix,
    cosine_residual_coverage,
    normalize_for_metric,
)
from repro_torch.core.engines.registry import register_engine
from repro_torch.kernels import ops as kops

__all__ = ["DeviceConfig", "DeviceEngine", "greedy_fl_device"]


def greedy_fl_device(
    feats: torch.Tensor,
    budget: int,
    *,
    q: int = 1,
    gains_impl: str = "auto",
    tile_dtype: str = "float32",
    stale_tol: float = 0.7,
    init_selected=None,
    stats: dict | None = None,
) -> FLResult:
    """Device-resident greedy FL from features.

    A sweep round runs one fused gains + argmax pass over every candidate
    (lowest index within a block, lowest block across blocks — i.e.
    ``torch.argmax`` order) and commits the winner.  Block-greedy mode
    (``q > 1``) keeps the sweep's gains as Minoux upper bounds; between
    sweeps it refreshes the top-P bounds against the updated cover state in
    one (n, d)×(d, P) matmul and commits the best refreshed candidate iff
    its fresh gain retains at least ``stale_tol`` of the best outstanding
    bound (``stale_tol=1.0`` is the exact Minoux rule).  Once the refresh
    budget is spent the engine sweeps again.  ``q=1`` is exact greedy.

    Args:
      feats: (n, d) proxy features.
      budget: r; clamped to n.
      q: max winners committed per sweep.
      gains_impl: 'auto' (CUDA kernel on a card, plain twin on the CPU) |
        'cuda' | 'torch'.
      tile_dtype: 'float32' | 'bfloat16' feature tiles; gains accumulate fp32.
      stale_tol: lazy-commit floor in (0, 1]; 1.0 = exact greedy at any q.
      init_selected: optional warm-start prefix.
      stats: optional dict that receives ``sweeps`` and ``lazy_rounds`` for
        this run; each lazy round is one host sync (its commit decision).
    """
    n, _ = feats.shape
    dev = feats.device
    feats = feats.float()
    budget = int(min(budget, n))
    impl = kops.resolve_impl(gains_impl, dev)
    if tile_dtype not in ("float32", "bfloat16"):
        raise ValueError(f"unsupported tile_dtype {tile_dtype!r}")

    sq = torch.sum(feats * feats, dim=-1)
    d_max = 2.0 * torch.sqrt(torch.max(sq)) + 1e-6
    feats_t = feats.to(kops.TILE_DTYPES[tile_dtype])  # cast once, not per sweep

    def sim_cols(idx: torch.Tensor) -> torch.Tensor:
        """(n, m) similarity of every point to elements ``idx`` ((m,))."""
        cf = feats.index_select(0, idx)
        d2 = sq[:, None] + sq.index_select(0, idx)[None, :] - 2.0 * (feats @ cf.T)
        return d_max - torch.sqrt(torch.clamp(d2, min=0.0))

    def sweep(cur_max, chosen):
        return kops.fl_gains_argmax(
            feats_t, feats_t, cur_max, sq, sq, d_max, chosen,
            tile_dtype=tile_dtype, gains_impl=impl,
        )

    init_idx, init_gains, cur_max, chosen = _replay_prefix(
        init_selected, budget, n, lambda e: sim_cols(e.view(1))[:, 0],
        device=dev,
    )
    r0 = init_idx.shape[0]
    q = max(1, int(q))
    # Stale bounds are refreshed P at a time; the refresh budget caps the
    # chew at ~1/4 sweep before a fresh sweep.
    refresh_p = min(128, n)
    max_fails = max(1, n // (4 * refresh_p))

    out_idx = torch.zeros((budget,), dtype=torch.int64, device=dev)
    out_g = torch.zeros((budget,), dtype=torch.float32, device=dev)
    out_idx[:r0] = init_idx
    out_g[:r0] = init_gains
    neg = torch.tensor(float("-inf"), device=dev)
    ub = torch.full((n,), float("-inf"), device=dev)
    count, commits, fails = r0, q, 0  # commits = q forces a sweep on entry
    sweeps = lazy_rounds = 0

    while count < budget:
        if commits >= q or fails >= max_fails:
            g, pg, pi = sweep(cur_max, chosen)
            sweeps += 1
            e = pi.index_select(0, torch.argmax(pg).view(1)).long()  # (1,)
            col = sim_cols(e)[:, 0]
            fresh = torch.sum(torch.clamp(col - cur_max, min=0.0))
            if q > 1:  # bounds matter only to lazy rounds
                ub = torch.where(chosen, neg, g).index_fill_(0, e, float("-inf"))
            cur_max = torch.maximum(cur_max, col)
            chosen.index_fill_(0, e, True)
            out_idx[count:count + 1] = e
            out_g[count] = fresh
            count, commits, fails = count + 1, 1, 0
            continue
        # Lazy round: refresh the top-P bounds in one matmul, then the
        # tolerance-scaled Minoux rule.  A stable descending sort keeps
        # jax.lax.top_k's order: equal bounds, lower index first.
        lazy_rounds += 1
        tg, tp = torch.sort(ub, descending=True, stable=True)
        tg, tp = tg[:refresh_p], tp[:refresh_p]
        cols = sim_cols(tp)  # (n, P)
        fresh_p = torch.sum(torch.clamp(cols - cur_max[:, None], min=0.0), dim=0)
        fresh_p = torch.where(torch.isfinite(tg), fresh_p, neg)  # chosen
        j = torch.argmax(fresh_p).view(1)
        e = tp.index_select(0, j)
        fresh = fresh_p.index_select(0, j)
        rest = torch.max(ub.index_fill(0, tp, float("-inf")))
        # Small slack absorbs the sweep-vs-column summation-order difference.
        commit = bool(fresh * (1.0 + 1e-5) + 1e-6 >= stale_tol * rest)  # host sync
        ub = ub.index_copy(0, tp, fresh_p)
        if commit:
            ub.index_fill_(0, e, float("-inf"))
            cur_max = torch.maximum(cur_max, cols.index_select(1, j)[:, 0])
            chosen.index_fill_(0, e, True)
            out_idx[count:count + 1] = e
            out_g[count:count + 1] = fresh
            count, commits, fails = count + 1, commits + 1, 0
        else:
            fails += 1

    if stats is not None:
        stats.update(sweeps=sweeps, lazy_rounds=lazy_rounds)
    # γ / coverage: exact assignment of every point to its nearest medoid.
    sel_sim = sim_cols(out_idx)  # (n, r)
    assign = torch.argmax(sel_sim, dim=1)  # first maximum, as jnp.argmax
    weights = torch.bincount(assign, minlength=budget).to(torch.float32)
    coverage = torch.sum(d_max - torch.max(sel_sim, dim=1).values)
    return FLResult(out_idx, out_g, weights, coverage)


@dataclasses.dataclass(frozen=True)
class DeviceConfig(EngineConfig):
    """Device-resident fused greedy.

    Attributes:
      q: winners committed per fused sweep (block greedy).  1 = exact
        greedy; larger amortizes the O(n²·d) sweep at large budgets.
      stale_tol: lazy-commit floor in (0, 1]; 1.0 = exact Minoux rule.
      tile_dtype: 'float32' | 'bfloat16' feature tiles (gains always
        accumulate fp32).
      gains_impl: 'auto' (CUDA kernel on a card, plain twin on the CPU) |
        'cuda' | 'torch'.

    The reference's pool and candidate tiles (``block_n``, ``block_m``)
    have no counterpart: the kernel streams every pool row through CTAs of
    its own candidate width, and the plain twin's width is the constant
    ``kernels.fl_gains.PLAIN_BLOCK_M``.
    """

    name: ClassVar[str] = "device"
    q: int = 1
    stale_tol: float = 0.7
    tile_dtype: str = "float32"
    gains_impl: str = "auto"


@register_engine
class DeviceEngine(SelectionEngine):
    name = "device"
    config_cls = DeviceConfig
    capabilities = Capabilities(
        exact=True,  # at the q=1 default (or stale_tol=1.0); near-exact past
        matrix_free=True,
        device_resident=True,
        supports_cover=False,
        supports_metrics=("l2", "cosine"),  # cosine via normalized l2
        memory=lambda n, d: 4 * n * (d + 2048),
    )

    def select(
        self, feats, budget, *, metric="l2", init_selected=None, rng=None
    ) -> FLResult:
        cfg = self.config
        feats = normalize_for_metric(feats, metric)
        res = greedy_fl_device(
            feats,
            budget,
            q=cfg.q,
            gains_impl=cfg.gains_impl,
            tile_dtype=cfg.tile_dtype,
            stale_tol=cfg.stale_tol,
            init_selected=init_selected,
        )
        if metric == "cosine":  # report L(S) in cosine-distance units
            res = res._replace(
                coverage=cosine_residual_coverage(feats, res.indices)
            )
        return res
