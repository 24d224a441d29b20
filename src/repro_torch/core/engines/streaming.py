"""Sieve-streaming facility-location engine.

Port of ``repro.core.engines.streaming``.  A geometric grid of threshold
sieves (Badanidiyuru et al., KDD'14) admits arriving elements one pass at
a time: for each guess v = (1+eps)^j of OPT a sieve takes an element whose
marginal gain clears (v/2 − f(S_v)) / (k − |S_v|).  Past points are not
revisited, so each sieve tracks the running sum of its coverage of the
deltas it has seen (``fval``), gains are estimated on the arriving delta,
and the grid anchors on the running max singleton *mean* similarity; when
that rises, sieve slots jump whole multiples of L levels and retire their
picks (the reference's module docstring has the full argument).

Three surfaces, as in the reference:

  * ``init_streaming_state`` / ``ingest_delta`` / ``streaming_result`` —
    the functional core over ``StreamingState``, a NamedTuple of tensors.
    ``ingest_delta`` never writes into the state it is given: it returns
    new tensors, so holding the old state is a snapshot.  The reference's
    ``lax.scan`` over the delta is a Python loop here; the (Δn, B)
    similarity columns come from one matrix product per block of B
    arrivals, and the selection arrays are rebuilt after the loop with one
    scatter.
  * ``StreamingEngine`` (``engine='streaming'``): one-shot ``select``
    (init → single-delta ingest → the dense finalize).
  * ``StreamingSelector``: sequential ``ingest`` calls, per-class budgets
    (paper §5), eviction (``compact``) and a JSON-able ``state_dict``
    whose format is the reference's, so a state written by either package
    resumes in the other.

``streaming_result_blocked`` is the finalize of the selector and the
coreset service: the warm prefix and the best sieve's picks are one
``fl_replay`` (the hand-written kernel on a card, its blocked twin on the
CPU), the farthest-point backfill stays a short sequential loop.
"""
from __future__ import annotations

import dataclasses
import math
from typing import ClassVar, NamedTuple

import numpy as np
import torch

from repro_torch._device import resolve_device
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

__all__ = [
    "LVL_UNSET",
    "StreamingConfig",
    "StreamingEngine",
    "StreamingSelector",
    "StreamingState",
    "init_streaming_state",
    "ingest_delta",
    "num_sieves",
    "streaming_result",
    "streaming_result_blocked",
]

# Level of a sieve slot never anchored; any real level is far above it.
LVL_UNSET = -(2**30)

# Arrivals per block of similarity columns in ``ingest_delta``.
INGEST_BLOCK = 256


class StreamingState(NamedTuple):
    """Sieve-streaming state, tensors only (the reference's pytree).

    Attributes (shapes as the reference's):
      n_seen: () int32 points ingested; d_max: () fp32 similarity offset
        frozen at the first ingest; m: () fp32 running max singleton mean.
      lvl (L,) int32 absolute level per slot; count (L,) int32 picks per
        sieve; fval (L,) fp32 running coverage sum; fval_pre () fp32 the
        warm prefix's alone.
      sel_idx (L, k) int32 picks (-1 = empty), sel_feats (L, k, d) fp32
        their features; pre_idx (r0,) int32, pre_feats (r0, d) fp32 the
        warm-start prefix.
    """

    n_seen: torch.Tensor
    d_max: torch.Tensor
    m: torch.Tensor
    lvl: torch.Tensor
    count: torch.Tensor
    fval: torch.Tensor
    fval_pre: torch.Tensor
    sel_idx: torch.Tensor
    sel_feats: torch.Tensor
    pre_idx: torch.Tensor
    pre_feats: torch.Tensor

    @property
    def capacity(self) -> int:
        """k — sieve capacity (budget minus warm-prefix length)."""
        return self.sel_idx.shape[1]

    @property
    def num_levels(self) -> int:
        """L — number of sieve slots."""
        return self.lvl.shape[0]


def num_sieves(budget: int, eps: float, levels: int = 0) -> int:
    """Sieve count: span the OPT window [m, 2·budget·m], i.e.
    log(2k)/log(1+eps) levels, capped at 64 and floored at 4; ``levels > 0``
    overrides."""
    if levels > 0:
        return int(levels)
    k = max(int(budget), 2)
    want = math.ceil(math.log(2.0 * k) / math.log1p(eps)) + 1
    return max(4, min(64, want))


def init_streaming_state(
    budget: int,
    dim: int,
    *,
    eps: float = 0.15,
    levels: int = 0,
    init_selected=None,
    init_feats=None,
    device: str | torch.device = "cuda",
) -> StreamingState:
    """Empty sieve grid for ``budget`` selections over ``dim``-d features
    on ``device`` (the card unless the caller asks for the CPU; raises
    where CUDA is absent and ``device`` is not ``"cpu"``).
    ``init_selected``/``init_feats`` seed a warm-start prefix: treated as
    already selected, excluded from admission, replayed first at finalize."""
    budget = int(budget)
    dev = resolve_device(device)
    if budget < 1:
        raise ValueError(f"budget must be ≥ 1, got {budget}")
    if init_selected is None:
        pre_idx = torch.zeros((0,), dtype=torch.int32, device=dev)
        pre_feats = torch.zeros((0, dim), dtype=torch.float32, device=dev)
    else:
        pre_idx = torch.as_tensor(np.asarray(init_selected, np.int32).ravel(), device=dev)
        if init_feats is None:
            raise ValueError("init_selected needs init_feats (past rows are gone)")
        pre_feats = torch.as_tensor(init_feats, dtype=torch.float32).to(dev).reshape(-1, dim)
        if pre_feats.shape[0] != pre_idx.shape[0]:
            raise ValueError(
                f"init_feats rows {pre_feats.shape[0]} != "
                f"init_selected length {pre_idx.shape[0]}"
            )
        if pre_idx.shape[0] > budget:
            raise ValueError(
                f"init_selected has {pre_idx.shape[0]} elements > budget {budget}"
            )
    k = budget - pre_idx.shape[0]
    L = num_sieves(budget, eps, levels)
    return StreamingState(
        n_seen=torch.zeros((), dtype=torch.int32, device=dev),
        d_max=torch.zeros((), dtype=torch.float32, device=dev),
        m=torch.zeros((), dtype=torch.float32, device=dev),
        lvl=torch.full((L,), LVL_UNSET, dtype=torch.int32, device=dev),
        count=torch.zeros((L,), dtype=torch.int32, device=dev),
        fval=torch.zeros((L,), dtype=torch.float32, device=dev),
        fval_pre=torch.zeros((), dtype=torch.float32, device=dev),
        sel_idx=torch.full((L, k), -1, dtype=torch.int32, device=dev),
        sel_feats=torch.zeros((L, k, dim), dtype=torch.float32, device=dev),
        pre_idx=pre_idx,
        pre_feats=pre_feats,
    )


def _clipped_sim(feats, sq, cols, sq_cols, d_max) -> torch.Tensor:
    """(Δn, c) similarity clipped at 0 of every delta point to ``cols``."""
    d2 = (sq[:, None] + sq_cols[None, :]) - 2.0 * (feats @ cols.T)
    return torch.clamp(d_max - torch.sqrt(torch.clamp(d2, min=0.0)), min=0.0)


def ingest_delta(state: StreamingState, feats, idx, eps: float) -> StreamingState:
    """One-pass sieve update over a delta; returns a new state.

    Work is O(Δn·(Δn + L·k)·d), independent of ``n_seen``: prior data is
    never revisited.  ``feats`` (Δn, d) and ``idx`` (Δn,) pool positions go
    to the state's device.
    """
    dev = state.lvl.device
    feats = torch.as_tensor(feats, dtype=torch.float32).to(dev)
    dn, dim = feats.shape
    L, k = state.num_levels, state.capacity
    r0 = state.pre_idx.shape[0]
    idx = torch.as_tensor(idx).to(device=dev, dtype=torch.int32)
    sq = torch.sum(feats * feats, dim=-1)

    # freeze the similarity offset at first ingest (later sims clip at 0)
    d_max = torch.where(
        state.n_seen == 0, 2.0 * torch.sqrt(torch.max(sq)) + 1e-6, state.d_max
    )

    # prefix coverage of the delta (the floor every sieve shares)
    if r0 > 0:
        psq = torch.sum(state.pre_feats * state.pre_feats, dim=-1)
        cov_pre = _clipped_sim(feats, sq, state.pre_feats, psq, d_max).max(dim=1).values
        is_pre = (idx[:, None] == state.pre_idx[None, :]).any(dim=1)
    else:
        cov_pre = torch.zeros((dn,), dtype=torch.float32, device=dev)
        is_pre = torch.zeros((dn,), dtype=torch.bool, device=dev)
    pre_sum = torch.sum(cov_pre)

    if k == 0:  # budget == prefix: nothing to sieve, just account coverage
        return state._replace(
            n_seen=state.n_seen + dn,
            d_max=d_max,
            fval=state.fval + pre_sum,
            fval_pre=state.fval_pre + pre_sum,
        )

    # coverage of the delta by each sieve's existing selections
    ssq = torch.sum(state.sel_feats * state.sel_feats, dim=-1)  # (L, k)
    dots = torch.einsum("nd,lkd->lnk", feats, state.sel_feats)
    d2s = (sq[None, :, None] + ssq[:, None, :]) - 2.0 * dots
    del dots
    sims = torch.clamp(d_max - torch.sqrt(torch.clamp(d2s, min=0.0)), min=0.0)
    del d2s
    valid = torch.arange(k, device=dev)[None, None, :] < state.count[:, None, None]
    cov = torch.where(valid, sims, 0.0).max(dim=2).values  # (L, Δn)
    del sims
    cov = torch.maximum(cov, cov_pre[None, :])

    n_seen_f = state.n_seen.float()
    log1p_eps = math.log1p(float(eps))
    slot_arange = torch.arange(L, dtype=torch.int32, device=dev)
    m, lvl, count, fval = state.m, state.lvl, state.count, state.fval
    covsum = torch.sum(cov, dim=1)
    not_pre = ~is_pre
    acc_hist, ret_hist = [], []
    # The loop carries only the O(L·Δn) cover rows and O(L) scalars; the
    # (L, k[, d]) selection arrays are rebuilt after it from the
    # accept/retire history, as in the reference.
    for b0 in range(0, dn, INGEST_BLOCK):
        cols = _clipped_sim(feats, sq, feats[b0:b0 + INGEST_BLOCK],
                            sq[b0:b0 + INGEST_BLOCK], d_max)
        for t in range(b0, min(b0 + INGEST_BLOCK, dn)):
            col = cols[:, t - b0]  # (Δn,)
            # grid anchor: running max singleton mean; re-anchor the window
            m = torch.maximum(m, torch.mean(col))
            j_lo = torch.floor(torch.log(m) / log1p_eps).to(torch.int32)
            unset = lvl == LVL_UNSET
            w = torch.clamp(-torch.div(lvl - j_lo, L, rounding_mode="floor"), min=0)
            lvl = torch.where(unset, j_lo + slot_arange, lvl + w * L)
            retire = unset | (w > 0)
            count = torch.where(retire, 0, count)
            cov = torch.where(retire[:, None], cov_pre[None, :], cov)
            covsum = torch.where(retire, pre_sum, covsum)
            fval = torch.where(retire, state.fval_pre, fval)

            # threshold admission, vectorized over the L sieves
            v = torch.exp(lvl.float() * log1p_eps)
            g_mean = torch.sum(torch.clamp(col[None, :] - cov, min=0.0), dim=1) / dn
            f_cur = (fval + covsum) / (n_seen_f + dn)
            thresh = (0.5 * v - f_cur) / torch.clamp(k - count, min=1).float()
            accept = (count < k) & (g_mean >= thresh) & (g_mean > 0.0) & not_pre[t]

            count = count + accept.to(torch.int32)
            cov_new = torch.maximum(cov, col[None, :])
            cov = torch.where(accept[:, None], cov_new, cov)
            covsum = torch.where(accept, torch.sum(cov_new, dim=1), covsum)
            acc_hist.append(accept)
            ret_hist.append(retire)
    acc_hist = torch.stack(acc_hist)  # (Δn, L)
    ret_hist = torch.stack(ret_hist)

    # Rebuild (sel_idx, sel_feats): a sieve keeps only admissions after its
    # last retirement, filling slots in arrival order from the pre-delta
    # count (never retired) or from 0.  One scatter of the kept entries.
    t_col = torch.arange(dn, device=dev)[:, None]
    last_ret = torch.where(ret_hist, t_col, -1).max(dim=0).values  # (L,)
    keep = acc_hist & (t_col >= last_ret[None, :])
    retired = last_ret >= 0
    base = torch.where(retired, 0, state.count)
    slot = base[None, :] + torch.cumsum(keep.to(torch.int32), dim=0) - 1
    sel_idx = torch.where(retired[:, None], -1, state.sel_idx)
    sel_feats = torch.where(retired[:, None, None], 0.0, state.sel_feats)
    tt, ll = keep.nonzero(as_tuple=True)
    ss = torch.clamp(slot[tt, ll], 0, k - 1)
    sel_idx[ll, ss] = idx[tt]
    sel_feats[ll, ss] = feats[tt]
    return state._replace(
        n_seen=state.n_seen + dn,
        d_max=d_max,
        m=m,
        lvl=lvl,
        count=count,
        fval=fval + covsum,
        fval_pre=state.fval_pre + pre_sum,
        sel_idx=sel_idx,
        sel_feats=sel_feats,
    )


def _offset(feats: torch.Tensor, sq: torch.Tensor, d_max) -> torch.Tensor:
    if d_max is None:
        return 2.0 * torch.sqrt(torch.max(sq)) + 1e-6
    return torch.as_tensor(d_max, dtype=torch.float32, device=feats.device)


def streaming_result(state: StreamingState, feats, budget: int, *, d_max=None) -> FLResult:
    """Finalize: best sieve → full FLResult against the pool (dense sweep).

    Order: warm prefix (replayed), then the best sieve's picks in admission
    order, then worst-covered backfill (farthest point) for any unfilled
    budget.  γ and coverage use this call's own offset, or the caller's
    ``d_max`` (the per-class selector passes one pool-wide offset).  One
    matrix-vector product per budget step plus an (n, budget) similarity:
    the plain reference that :func:`streaming_result_blocked` is held to.
    """
    feats = torch.as_tensor(feats, dtype=torch.float32)
    dev = feats.device
    n = feats.shape[0]
    budget = int(min(int(budget), n))
    if budget < 1:
        raise ValueError(f"budget must be ≥ 1, got {budget}")
    k = state.capacity
    r0 = state.pre_idx.shape[0]
    if r0 > budget:
        raise ValueError(f"warm prefix {r0} exceeds finalize budget {budget}")
    sq = torch.sum(feats * feats, dim=-1)
    d_maxf = _offset(feats, sq, d_max)

    def sim_cols(e_arr: torch.Tensor) -> torch.Tensor:
        """(n, c) similarity of every pool point to elements ``e_arr``."""
        cf = feats[e_arr]
        d2 = (sq[:, None] + torch.sum(cf * cf, dim=-1)[None, :]) - 2.0 * (feats @ cf.T)
        return d_maxf - torch.sqrt(torch.clamp(d2, min=0.0))

    init_idx, init_gains, cur_max, chosen = _replay_prefix(
        state.pre_idx.to(dev) if r0 > 0 else None, budget, n,
        lambda e: sim_cols(e.view(1))[:, 0], device=dev,
    )
    best = torch.argmax(state.fval.to(dev))  # first maximum, as jnp.argmax
    cand = torch.clamp(state.sel_idx.to(dev)[best].long(), -1, n - 1)  # (k,)
    ccount = state.count.to(dev)[best]
    neg = torch.tensor(float("-inf"), device=dev)
    new_idx, new_gains = [], []
    for t in range(budget - r0):
        resid = torch.where(chosen, neg, d_maxf - cur_max)
        e = torch.argmax(resid)
        if k > 0:
            se = cand[min(t, k - 1)]
            se_safe = torch.clamp(se, 0, n - 1)
            use = (t < ccount) & (se >= 0) & ~chosen[se_safe]
            e = torch.where(use, se_safe, e)
        col = sim_cols(e.view(1))[:, 0]
        new_gains.append(torch.sum(torch.clamp(col - cur_max, min=0.0)))
        cur_max = torch.maximum(cur_max, col)
        chosen = chosen.index_fill(0, e.view(1), True)
        new_idx.append(e)
    indices = torch.cat([init_idx, torch.stack(new_idx).long()]) if new_idx else init_idx
    gains = torch.cat([init_gains, torch.stack(new_gains)]) if new_gains else init_gains

    sel_sim = sim_cols(indices)  # (n, budget)
    assign = torch.argmax(sel_sim, dim=1)  # first maximum, as jnp.argmax
    weights = torch.bincount(assign, minlength=budget).to(torch.float32)
    coverage = torch.sum(d_maxf - torch.max(sel_sim, dim=1).values)
    return FLResult(indices, gains.float(), weights, coverage)


def _backfill_step(feats, sq, d_maxf, cur, chosen, bv, bi, pos: int):
    """One farthest-point backfill pick + incremental γ/coverage update."""
    resid = torch.where(chosen, float("-inf"), d_maxf - cur)
    e = torch.argmax(resid)
    x = feats[e]
    d2 = (sq + torch.sum(x * x)) - 2.0 * (feats @ x)
    col = d_maxf - torch.sqrt(torch.clamp(d2, min=0.0))
    gain = torch.sum(torch.clamp(col - cur, min=0.0))
    upd = col > bv
    return (
        e,
        gain,
        torch.maximum(cur, col),
        chosen.index_fill(0, e.view(1), True),
        torch.where(upd, col, bv),
        torch.where(upd, pos, bi),
    )


FINALIZE_IMPLS = ("auto", "cuda", "torch", "dense")


def streaming_result_blocked(
    state: StreamingState,
    feats,
    budget: int,
    *,
    d_max=None,
    impl: str = "auto",
    block_m: int = 128,
) -> FLResult:
    """Blocked finalize: the result of :func:`streaming_result` without the
    per-step dense sweep.

    The pick sequence is [warm prefix | best sieve's picks | backfill]; the
    first two are known from the sieve's O(L + k) metadata (read on the
    host), so they replay in one ``kops.fl_replay`` that also carries each
    row's best pick for γ; only the backfill stays sequential.

    ``impl``: 'auto' (the ``fl_replay`` kernel on a card, its blocked twin
    on the CPU) | 'cuda' | 'torch' | 'dense' (delegate to
    :func:`streaming_result`).
    """
    if impl not in FINALIZE_IMPLS:
        raise ValueError(f"unknown finalize impl {impl!r}; expected one of {FINALIZE_IMPLS}")
    if impl == "dense":
        return streaming_result(state, feats, budget, d_max=d_max)
    feats = torch.as_tensor(feats, dtype=torch.float32)
    dev = feats.device
    impl = kops.resolve_impl(impl, dev)
    n = feats.shape[0]
    budget = int(min(int(budget), n))
    if budget < 1:
        raise ValueError(f"budget must be ≥ 1, got {budget}")
    k = state.capacity
    r0 = state.pre_idx.shape[0]
    if r0 > budget:
        raise ValueError(f"warm prefix {r0} exceeds finalize budget {budget}")

    # host pick plan from the sieve's O(L + k) metadata
    pre = state.pre_idx.cpu().numpy().astype(np.int64)
    if k > 0:
        best = int(torch.argmax(state.fval))
        cand = np.clip(state.sel_idx[best].cpu().numpy().astype(np.int64), -1, n - 1)
        ccount = int(state.count[best])
    else:
        cand = np.zeros((0,), np.int64)
        ccount = 0
    u = max(0, min(ccount, budget - r0))
    ordered = np.concatenate([pre, cand[:u]])
    if len(ordered) and ((ordered < 0).any() or len(np.unique(ordered)) != len(ordered)):
        # a pick collides with the prefix or repeats: only a malformed
        # state does this; the dense scan's per-step guards handle it
        return streaming_result(state, feats, budget, d_max=d_max)

    sq = torch.sum(feats * feats, dim=-1)
    d_maxf = _offset(feats, sq, d_max)
    m = len(ordered)
    eidx = torch.as_tensor(ordered, device=dev)
    if m > 0:
        gains_o, cur, bv, bi = kops.fl_replay(
            feats, feats[eidx], torch.ones((m,), dtype=torch.bool, device=dev),
            torch.zeros((n,), dtype=torch.float32, device=dev), d_maxf,
            impl=impl, block_m=block_m,
        )
    else:
        gains_o = torch.zeros((0,), dtype=torch.float32, device=dev)
        cur = torch.zeros((n,), dtype=torch.float32, device=dev)
        bv = torch.full((n,), -1e30, dtype=torch.float32, device=dev)
        bi = torch.zeros((n,), dtype=torch.int32, device=dev)
    chosen = torch.zeros((n,), dtype=torch.bool, device=dev)
    chosen[eidx] = True

    back_idx, back_gains = [], []
    for t in range(budget - m):
        e, g, cur, chosen, bv, bi = _backfill_step(feats, sq, d_maxf, cur, chosen, bv, bi, m + t)
        back_idx.append(e)
        back_gains.append(g)
    indices = torch.cat([eidx, torch.stack(back_idx)]) if back_idx else eidx
    gains = torch.cat([gains_o, torch.stack(back_gains)]) if back_gains else gains_o
    weights = torch.bincount(bi.long(), minlength=budget).to(torch.float32)
    coverage = torch.sum(d_maxf - bv)
    return FLResult(indices, gains.float(), weights, coverage)


# ---------------------------------------------------------------------------
# Registry plugin: one-shot select behind the common protocol
# ---------------------------------------------------------------------------


@dataclasses.dataclass(frozen=True)
class StreamingConfig(EngineConfig):
    """Sieve-streaming engine knobs.

    Attributes:
      eps: geometric grid density — thresholds are ``(1+eps)^j``.
      levels: sieve-slot count override (0 = auto, :func:`num_sieves`).
      finalize_impl: the ``StreamingSelector`` finalize: 'auto' (the
        ``fl_replay`` kernel on a card, its blocked twin on the CPU) |
        'cuda' | 'torch' | 'dense'.  The one-shot ``StreamingEngine.select``
        always takes the dense path.
      finalize_block_m: candidate block of the blocked twin.
    """

    name: ClassVar[str] = "streaming"
    eps: float = 0.15
    levels: int = 0
    finalize_impl: str = "auto"
    finalize_block_m: int = 128


@register_engine
class StreamingEngine(SelectionEngine):
    name = "streaming"
    config_cls = StreamingConfig
    capabilities = Capabilities(
        exact=False,  # (1/2 − eps) sieve guarantee, not exact greedy
        matrix_free=True,
        device_resident=True,
        supports_cover=False,
        supports_metrics=("l2", "cosine"),  # cosine via normalized l2
        # state is L·k·d plus the pool it sweeps: L≈48, k≈n/20 heuristic
        memory=lambda n, d: 4 * (n * d + 48 * d * max(n // 20, 64)),
    )

    def select(
        self, feats, budget, *, metric="l2", init_selected=None, rng=None
    ) -> FLResult:
        feats = normalize_for_metric(torch.as_tensor(feats, dtype=torch.float32), metric)
        n = feats.shape[0]
        budget = int(min(int(budget), n))
        kw = dict(eps=self.config.eps, levels=self.config.levels, device=feats.device)
        if init_selected is not None:
            init_idx = np.asarray(init_selected, np.int64).ravel()
            if init_idx.shape[0] > budget:
                raise ValueError(
                    f"init_selected has {init_idx.shape[0]} elements > budget {budget}"
                )
            state = init_streaming_state(
                budget, feats.shape[1], init_selected=init_idx,
                init_feats=feats[torch.as_tensor(init_idx, device=feats.device)], **kw,
            )
        else:
            state = init_streaming_state(budget, feats.shape[1], **kw)
        if state.capacity > 0:
            # the whole pool as ONE delta: textbook sieve-streaming
            state = ingest_delta(
                state, feats, torch.arange(n, dtype=torch.int32), self.config.eps
            )
        res = streaming_result(state, feats, budget)
        if metric == "cosine":  # report L(S) in cosine-distance units
            res = res._replace(coverage=cosine_residual_coverage(feats, res.indices))
        return res


# ---------------------------------------------------------------------------
# Stateful wrapper: the coreset service's selection core
# ---------------------------------------------------------------------------

_FLAT = "__flat__"

_STATE_DTYPES = {
    "n_seen": np.int32, "d_max": np.float32, "m": np.float32,
    "lvl": np.int32, "count": np.int32, "fval": np.float32,
    "fval_pre": np.float32, "sel_idx": np.int32, "sel_feats": np.float32,
    "pre_idx": np.int32, "pre_feats": np.float32,
}


def _state_to_dict(state: StreamingState) -> dict:
    """JSON-able snapshot: shapes + flat lists (float32 ↔ float round-trips
    exactly, so restores are bit-identical)."""
    out = {}
    for name in StreamingState._fields:
        arr = getattr(state, name).cpu().numpy()
        out[name] = {"shape": list(arr.shape), "data": arr.ravel().tolist()}
    return out


def _state_from_dict(d: dict, device: torch.device) -> StreamingState:
    """Inverse of ``_state_to_dict``; also takes the fields as tensors
    (``StreamingSelector.state_dict(tensors=True)``)."""
    kw = {}
    for name in StreamingState._fields:
        spec = d[name]
        if isinstance(spec, torch.Tensor):
            kw[name] = spec.to(device)
            continue
        arr = np.asarray(spec["data"], _STATE_DTYPES[name]).reshape(spec["shape"])
        kw[name] = torch.from_numpy(arr).to(device)
    return StreamingState(**kw)


class StreamingSelector:
    """Stateful sieve-streaming selection over a pool arriving in deltas.

    As ``CraigSelector`` where it can be: Σγ equals the pool size, per-class
    mode stratifies budgets ∝ observed class arrivals (paper §5, the same
    largest-remainder rule), and a flat warm-start prefix stays at the
    front of the result.  ``ingest`` is called once per delta (O(Δn·k), no
    re-sweep); ``result`` finalizes against the accumulated pool.

    Pool positions are arrival order, so the ``feats`` given to
    :meth:`result` are the ingested deltas concatenated in order.  With
    ``evict=True`` they are live-pool positions: :meth:`compact` drops
    every row no sieve references, the caller applies the same row
    selection to its buffer, and :attr:`live_ids` maps live positions to
    arrival order.

    The sieve states live on ``device`` (the card unless the caller asks
    for the CPU); ``state_dict``/``load_state_dict`` round-trip the full
    state bit-identically in the reference's JSON format.
    """

    def __init__(
        self,
        budget: int,
        dim: int,
        *,
        config: StreamingConfig | None = None,
        metric: str = "l2",
        per_class: bool = False,
        evict: bool = False,
        init_selected=None,
        init_feats=None,
        device: str | torch.device = "cuda",
    ):
        config = config or StreamingConfig()
        caps = StreamingEngine.capabilities
        if metric not in caps.supports_metrics:
            raise ValueError(
                f"engine 'streaming' supports metrics {caps.supports_metrics}, "
                f"got {metric!r}"
            )
        if per_class and init_selected is not None:
            raise ValueError(
                "warm-start prefix is flat-mode only (per-class budgets are "
                "apportioned at result time, after arrival counts are known)"
            )
        self.device = resolve_device(device)
        self.budget = int(budget)
        self.dim = int(dim)
        self.config = config
        self.metric = metric
        self.per_class = bool(per_class)
        self.evict = bool(evict)
        self._n_seen = 0
        self._n_rows = 0  # live pool rows (== n_seen unless evict compacts)
        self._live = np.zeros((0,), np.int64)  # live pos -> global arrival id
        self._class_seen: dict = {}  # label -> total arrivals (pre-eviction)
        self._states: dict = {}
        self._rows: dict = {}  # label -> pool positions, class-arrival order
        if not per_class:
            if init_feats is not None:
                init_feats = normalize_for_metric(
                    torch.as_tensor(init_feats, dtype=torch.float32).to(self.device), metric
                )
            self._states[_FLAT] = self._new_state(init_selected, init_feats)

    def _new_state(self, init_selected=None, init_feats=None) -> StreamingState:
        return init_streaming_state(
            self.budget, self.dim, eps=self.config.eps, levels=self.config.levels,
            init_selected=init_selected, init_feats=init_feats, device=self.device,
        )

    @property
    def n_seen(self) -> int:
        """Total points ingested so far (eviction never lowers it)."""
        return self._n_seen

    @property
    def n_rows(self) -> int:
        """Live pool rows the next :meth:`result` call expects."""
        return self._n_rows

    @property
    def live_ids(self) -> np.ndarray:
        """(n_rows,) int64 global arrival id of each live pool position."""
        if not self.evict:
            return np.arange(self._n_rows, dtype=np.int64)
        return self._live.copy()

    def state(self, label=None) -> StreamingState:
        """The sieve state of the flat selector, or of class ``label``."""
        return self._states[_FLAT if label is None else int(label)]

    def _feats(self, feats) -> torch.Tensor:
        return normalize_for_metric(
            torch.as_tensor(feats, dtype=torch.float32).to(self.device), self.metric
        )

    def ingest(self, feats, labels=None) -> int:
        """Ingest one delta; returns the running pool size.

        O(Δn·(Δn + L·k)·d), independent of the pool ingested so far.
        """
        feats = self._feats(feats)
        if feats.dim() != 2 or feats.shape[1] != self.dim:
            raise ValueError(f"expected (Δn, {self.dim}) features, got {tuple(feats.shape)}")
        dn = feats.shape[0]
        if self.per_class:
            if labels is None:
                raise ValueError("per_class=True ingest needs labels")
            labels = np.asarray(labels).ravel()
            if labels.shape[0] != dn:
                raise ValueError(f"labels length {labels.shape[0]} != Δn {dn}")
            for c in np.unique(labels):
                key = int(c)
                pos = np.nonzero(labels == c)[0]
                rows = self._rows.setdefault(key, [])
                if key not in self._states:
                    self._states[key] = self._new_state()
                local = len(rows) + np.arange(pos.size, dtype=np.int32)
                self._states[key] = ingest_delta(
                    self._states[key], feats[torch.as_tensor(pos, device=self.device)],
                    local, self.config.eps,
                )
                rows.extend((self._n_rows + pos).tolist())
                self._class_seen[key] = self._class_seen.get(key, 0) + int(pos.size)
        else:
            idx = self._n_rows + np.arange(dn, dtype=np.int32)
            self._states[_FLAT] = ingest_delta(
                self._states[_FLAT], feats, idx, self.config.eps
            )
        if self.evict:
            self._live = np.concatenate(
                [self._live, self._n_seen + np.arange(dn, dtype=np.int64)]
            )
        self._n_seen += int(dn)
        self._n_rows += int(dn)
        return self._n_seen

    def compact(self) -> np.ndarray:
        """Evict pool rows no sieve references (``evict=True`` only).

        Keeps the rows any sieve's ``sel_idx`` or the warm prefix
        references, remaps every stored index, and returns the kept
        positions (ascending, pre-compaction order); the caller MUST apply
        the same row selection to its pool before the next :meth:`result`.
        The identity when ``evict=False``.
        """
        if not self.evict or self._n_rows == 0:
            return np.arange(self._n_rows, dtype=np.int64)
        if not self.per_class:
            st = self._states[_FLAT]
            sel = st.sel_idx.cpu().numpy().astype(np.int64)
            pre = st.pre_idx.cpu().numpy().astype(np.int64)
            keep = np.unique(np.concatenate([sel[sel >= 0].ravel(), pre]))
            new_sel = np.where(
                sel >= 0, np.searchsorted(keep, np.clip(sel, 0, None)), -1
            ).astype(np.int32)
            self._states[_FLAT] = st._replace(
                sel_idx=torch.from_numpy(new_sel).to(self.device),
                pre_idx=torch.from_numpy(
                    np.searchsorted(keep, pre).astype(np.int32)).to(self.device),
            )
        else:
            keep_mask = np.zeros(self._n_rows, bool)
            kept_local: dict = {}
            for c, st in self._states.items():
                sel = st.sel_idx.cpu().numpy().astype(np.int64)
                kl = np.unique(sel[sel >= 0].ravel())
                kept_local[c] = kl
                keep_mask[np.asarray(self._rows[c], np.int64)[kl]] = True
            keep = np.nonzero(keep_mask)[0].astype(np.int64)
            pool_remap = np.full(self._n_rows, -1, np.int64)
            pool_remap[keep] = np.arange(len(keep))
            for c, st in self._states.items():
                kl = kept_local[c]
                sel = st.sel_idx.cpu().numpy().astype(np.int64)
                new_sel = np.where(
                    sel >= 0, np.searchsorted(kl, np.clip(sel, 0, None)), -1
                ).astype(np.int32)
                self._states[c] = st._replace(sel_idx=torch.from_numpy(new_sel).to(self.device))
                rows_c = np.asarray(self._rows[c], np.int64)
                self._rows[c] = pool_remap[rows_c[kl]].tolist()
        self._live = self._live[keep]
        self._n_rows = int(len(keep))
        return keep

    def result(self, feats) -> FLResult:
        """Finalize the current selection against the accumulated pool.

        ``feats``: the ingested deltas concatenated in arrival order (after
        :meth:`compact`, with the same rows kept).  Indices are pool
        positions; map them through :attr:`live_ids` when ``evict=True``.
        """
        feats = self._feats(feats)
        n = feats.shape[0]
        if n != self._n_rows:
            raise ValueError(
                f"pool has {n} rows but {self._n_rows} are live — result() "
                "needs the ingested deltas concatenated in order, compacted "
                "in lockstep with compact()"
            )
        if n == 0:
            raise ValueError("nothing ingested yet")
        impl = self.config.finalize_impl
        bm = self.config.finalize_block_m
        if not self.per_class:
            res = streaming_result_blocked(
                self._states[_FLAT], feats, min(self.budget, n), impl=impl, block_m=bm,
            )
            if self.metric == "cosine":
                res = res._replace(coverage=cosine_residual_coverage(feats, res.indices))
            return res

        # paper §5: stratified budgets ∝ observed class arrival counts
        from repro_torch.core.craig import _apportion_budgets  # lazy: avoid cycle

        classes = sorted(self._states)
        counts = np.array(
            [self._class_seen.get(c, len(self._rows[c])) for c in classes], np.int64
        )
        budgets = _apportion_budgets(counts, min(self.budget, n))
        # one pool-wide offset so per-class gains/coverages share units
        d_max_pool = 2.0 * torch.sqrt(torch.max(torch.sum(feats * feats, dim=-1))) + 1e-6
        all_idx, all_gains, all_w = [], [], []
        coverage = 0.0
        for c, b in zip(classes, budgets):
            b = int(min(b, len(self._rows[c])))
            if b == 0:
                continue
            rows = torch.as_tensor(self._rows[c], dtype=torch.int64, device=self.device)
            sub = feats[rows]
            r = streaming_result_blocked(
                self._states[c], sub, b, d_max=d_max_pool, impl=impl, block_m=bm,
            )
            all_idx.append(rows[r.indices])
            all_gains.append(r.gains)
            all_w.append(r.weights)
            coverage += float(
                cosine_residual_coverage(sub, r.indices) if self.metric == "cosine"
                else r.coverage
            )
        return FLResult(
            torch.cat(all_idx), torch.cat(all_gains), torch.cat(all_w),
            torch.tensor(coverage, dtype=torch.float32),
        )

    # -- snapshots -------------------------------------------------------------

    def snapshot(self) -> dict:
        """In-memory checkpoint for :meth:`restore`: O(L + rows) host work,
        no copy of the sieve tensors (``ingest_delta`` and :meth:`compact`
        replace them rather than write into them)."""
        return {
            "n_seen": self._n_seen, "n_rows": self._n_rows, "live": self._live,
            "class_seen": dict(self._class_seen), "states": dict(self._states),
            "rows": {c: list(r) for c, r in self._rows.items()},
        }

    def restore(self, snap: dict) -> None:
        """Return to a :meth:`snapshot` of this selector."""
        self._n_seen, self._n_rows, self._live = snap["n_seen"], snap["n_rows"], snap["live"]
        self._class_seen = dict(snap["class_seen"])
        self._states = dict(snap["states"])
        self._rows = {c: list(r) for c, r in snap["rows"].items()}

    # -- serialization -------------------------------------------------------

    def state_dict(self, tensors: bool = False) -> dict:
        """JSON-able full snapshot (config + per-class sieve states + the
        eviction remap), in the reference's format.  With ``tensors`` each
        sieve state stays a dict of its tensors (for a checkpoint's tensor
        tree: the L·k·d picked features are too many for JSON lists)."""
        return {
            "budget": self.budget,
            "dim": self.dim,
            "metric": self.metric,
            "per_class": self.per_class,
            "evict": self.evict,
            "n_seen": self._n_seen,
            "n_rows": self._n_rows,
            "live": self._live.tolist(),
            "class_seen": {str(key): int(v) for key, v in self._class_seen.items()},
            "config": self.config.to_dict(),
            "states": {str(key): st._asdict() if tensors else _state_to_dict(st)
                       for key, st in self._states.items()},
            "rows": {str(key): list(rows) for key, rows in self._rows.items()},
        }

    def load_state_dict(self, d: dict) -> None:
        """Inverse of :meth:`state_dict`, bit-identical; also takes the dict
        the reference's ``StreamingSelector.state_dict`` writes (its
        finalize names map through ``repro_torch.convert``)."""
        from repro_torch.convert import engine_config_from_reference  # lazy: cycle

        cfg = engine_config_from_reference(d["config"])
        if not isinstance(cfg, StreamingConfig):
            raise ValueError(f"not a streaming state_dict: {d['config']!r}")
        self.budget = int(d["budget"])
        self.dim = int(d["dim"])
        self.metric = d["metric"]
        self.per_class = bool(d["per_class"])
        self.evict = bool(d.get("evict", False))
        self.config = cfg
        self._n_seen = int(d["n_seen"])
        self._n_rows = int(d.get("n_rows", d["n_seen"]))
        self._live = np.asarray(d.get("live", []), np.int64)
        self._states = {
            (key if key == _FLAT else int(key)): _state_from_dict(sd, self.device)
            for key, sd in d["states"].items()
        }
        self._rows = {int(key): list(rows) for key, rows in d["rows"].items()}
        self._class_seen = {
            int(key): int(v) for key, v in d.get("class_seen", {}).items()
        } or {c: len(r) for c, r in self._rows.items()}
