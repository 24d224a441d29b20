"""Public kernel wrappers: dispatch and input checks.

Port of ``repro.kernels.ops`` (``fl_gains``, ``fl_gains_argmax``,
``ce_proxy``, ``topk_sim``, ``pairwise_l2``, ``fl_replay``).  The
reference pads to block and lane multiples and picks
Pallas interpret mode off the TPU; here the CUDA kernels mask ragged edges
themselves, so the wrappers only arrange operands and dispatch
(``gains_impl``, or ``impl`` for the others):

  * ``'auto'``: the CUDA kernel for CUDA tensors, the plain twin for CPU
    tensors;
  * ``'cuda'``: the kernel; raises for tensors that are not on a card;
  * ``'torch'``: the plain twin, on whatever device the tensors are.

Nothing falls back: a kernel that fails to build or launch raises.
:data:`LAUNCHES` counts kernel launches per kernel.
"""
from __future__ import annotations

import torch
from torch.distributed.tensor import DTensor, Shard

from repro_torch.kernels import _build
from repro_torch.kernels import ce_proxy as _ce
from repro_torch.kernels import fl_gains as _fl
from repro_torch.kernels import pairwise_l2 as _pw
from repro_torch.kernels import topk_sim as _tk

__all__ = ["fl_gains", "fl_gains_argmax", "ce_proxy", "topk_sim", "pairwise_l2",
           "fl_replay", "resolve_impl", "token_slice", "LAUNCHES", "TILE_DTYPES"]

LAUNCHES = _build.LAUNCHES
TILE_DTYPES = _fl.TILE_DTYPES

GAINS_IMPLS = ("auto", "cuda", "torch")


def resolve_impl(gains_impl: str, device: torch.device) -> str:
    """'auto' → 'cuda' on a card, 'torch' on the CPU; checks the others."""
    if gains_impl not in GAINS_IMPLS:
        raise ValueError(
            f"unknown gains_impl {gains_impl!r}; expected one of {GAINS_IMPLS}"
        )
    if gains_impl == "auto":
        return "cuda" if device.type == "cuda" else "torch"
    if gains_impl == "cuda" and device.type != "cuda":
        raise ValueError(
            f"gains_impl='cuda' needs CUDA tensors, got tensors on {device}"
        )
    return gains_impl


def _scalar(d_max, device) -> torch.Tensor:
    return torch.as_tensor(d_max, dtype=torch.float32, device=device)


def fl_gains(
    x: torch.Tensor,
    e: torch.Tensor,
    cur_max: torch.Tensor,
    sqx: torch.Tensor,
    sqe: torch.Tensor,
    d_max,
    *,
    gains_impl: str = "auto",
    block_m: int = 512,
) -> torch.Tensor:
    """Marginal FL gains of candidates ``e`` against pool ``x``.

    gains[c] = Σ_i relu((d_max − ‖x_i − e_c‖) − cur_max_i).

    Args:
      x: (n, d) fp32 pool; e: (m, d) fp32 candidates.
      cur_max: (n,) fp32 cover state; sqx (n,), sqe (m,) fp32 squared norms.
      d_max: fp32 scalar similarity offset (tensor or number).
      block_m: candidate block of the plain twin (the kernel uses its own).
    Returns:
      (m,) fp32 gains.
    """
    impl = resolve_impl(gains_impl, x.device)
    d_max = _scalar(d_max, x.device)
    if impl == "torch":
        return _fl.fl_gains_torch(x, e, cur_max, sqx, sqe, d_max, block_m=block_m)
    madj = (d_max - cur_max.float()).contiguous()
    return _fl.fl_gains_cuda(
        x.contiguous(), e.contiguous(), madj, sqx.float().contiguous(),
        sqe.float().contiguous(),
    )


def fl_gains_argmax(
    x: torch.Tensor,
    e: torch.Tensor,
    cur_max: torch.Tensor,
    sqx: torch.Tensor,
    sqe: torch.Tensor,
    d_max,
    chosen: torch.Tensor,
    *,
    tile_dtype: str = "float32",
    gains_impl: str = "auto",
) -> tuple[torch.Tensor, torch.Tensor, torch.Tensor]:
    """One fused greedy round: gains sweep + per-block argmax partials.

    Args:
      x: (n, d) pool, e: (m, d) candidates; cast to ``tile_dtype``
        ('float32' | 'bfloat16') unless they already are.
      cur_max: (n,) fp32 cover state; sqx (n,), sqe (m,) fp32 squared norms
        of the fp32 features.
      d_max: fp32 scalar similarity offset.
      chosen: (m,) bool — candidates that must not win.
    Returns:
      (gains (m,) fp32 un-penalized, part_g (m_blocks,) fp32,
      part_i (m_blocks,) int32); the kernel and the plain twin each use
      their own block width, and only the global winner
      ``part_i[argmax(part_g)]`` is width-independent.  ``part_i[argmax(part_g)]`` is the winner
      in ``torch.argmax`` order; all-chosen blocks report ≤ −1e29.
    """
    if tile_dtype not in TILE_DTYPES:
        raise ValueError(f"unsupported tile_dtype {tile_dtype!r}")
    td = TILE_DTYPES[tile_dtype]
    impl = resolve_impl(gains_impl, x.device)
    d_max = _scalar(d_max, x.device)
    x_t, e_t = x.to(td), e.to(td)
    if impl == "torch":
        return _fl.fl_gains_argmax_torch(
            x_t, e_t, cur_max, sqx, sqe, d_max, chosen.bool()
        )
    madj = (d_max - cur_max.float()).contiguous()
    return _fl.fl_gains_argmax_cuda(
        x_t.contiguous(), e_t.contiguous(), madj, sqx.float().contiguous(),
        sqe.float().contiguous(), chosen.bool().contiguous(),
    )


def ce_proxy(
    hidden: torch.Tensor,
    unembed: torch.Tensor,
    labels: torch.Tensor,
    *,
    valid_v: int | None = None,
    compute_dtype: torch.dtype = torch.float32,
    impl: str = "auto",
) -> torch.Tensor:
    """Fused per-token CRAIG proxy g = softmax(h Wᵀ) W − W[y] → (T, D) fp32.

    Args:
      hidden: (T, D) hidden states (any float dtype; cast to
        ``compute_dtype``).
      unembed: (V, D) vocab-major unembedding — the transpose of the
        reference's (D, V) ``unembed`` argument.
      labels: (T,) integer labels.
      valid_v: real vocab size when W is padded (columns at or past it are
        −∞); None means all V columns are real.
      compute_dtype: dtype of the two matrix products (torch.float32 or
        torch.bfloat16); accumulation and the softmax state stay fp32.
        On a card the bf16 kernel is the production route (every D).
        The fp32 kernel is for parity with the reference only: it runs
        on the CUDA cores and is several times slower than the plain
        twin (``impl='torch'``), whose fp32 GEMMs go through cuBLAS; PERF.md
        has the times.
      impl: 'auto' | 'cuda' | 'torch', as ``gains_impl`` above.
    """
    if compute_dtype not in _ce.COMPUTE_DTYPES:
        raise ValueError(f"unsupported compute_dtype {compute_dtype}")
    V = unembed.shape[0]
    vv = V if valid_v is None else int(valid_v)
    if not 1 <= vv <= V:
        raise ValueError(f"valid_v={valid_v} outside [1, V={V}]")
    if resolve_impl(impl, hidden.device) == "torch":
        if isinstance(hidden, DTensor):
            # on a mesh as the kernel's sharding rule places it: each device
            # its own tokens, the unembedding whole
            return _token_local(
                lambda h, w, y: _ce.ce_proxy_torch(h, w, y, vv, compute_dtype),
                hidden, unembed, labels)
        return _ce.ce_proxy_torch(hidden, unembed, labels, vv, compute_dtype)
    w = unembed.to(compute_dtype).contiguous()
    h = hidden.to(compute_dtype).contiguous()
    y = labels.to(torch.int32).contiguous()
    if isinstance(h, DTensor) and any(p == Shard(0) for p in h.placements):
        # on a mesh the op's sharding rule gives each device its own tokens
        return _ce.ce_proxy_cuda(h, w, y, vv)
    # one launch a slice (of tokens every device holds, on a mesh) of tokens below the kernel's 2**31-element operand
    # limit (the reference's select_pool batch, 256 × 4,096 tokens of D =
    # 2,048, is 2**31): a token's proxy depends on its own row alone
    rows = token_slice(h.shape[0], h.shape[1])
    if rows >= h.shape[0]:
        return _ce.ce_proxy_cuda(h, w, y, vv)
    return torch.cat([_ce.ce_proxy_cuda(h[lo:lo + rows], w, y[lo:lo + rows], vv)
                      for lo in range(0, h.shape[0], rows)])


def _token_local(fn, hidden, unembed, labels):
    """``fn(hidden, unembed, labels)`` on each device's tokens (``local_map``):
    hidden and labels keep their split of dim 0 and are whole otherwise,
    the unembedding whole."""
    from torch.distributed.tensor import Replicate, Shard
    from torch.distributed.tensor.experimental import local_map

    rows = [p if p == Shard(0) else Replicate() for p in hidden.placements]
    whole = [Replicate()] * len(rows)
    return local_map(fn, out_placements=rows, in_placements=(rows, whole, rows),
                     device_mesh=hidden.device_mesh, redistribute_inputs=True)(
        hidden, unembed, labels)


def token_slice(T: int, D: int) -> int:
    """Tokens a ``ce_proxy`` launch takes: all T, or T split evenly into
    the fewest slices whose (rows, D) operand stays below 2**31 elements."""
    most = (2**31 - 1) // max(D, 1)
    n = -(-T // most)
    return -(-T // n)


def topk_sim(
    x: torch.Tensor,
    k: int,
    d_max=None,
    *,
    impl: str = "auto",
    block_m: int = 2048,
) -> tuple[torch.Tensor, torch.Tensor]:
    """Top-k similarity graph rows of the pool against itself.

    Returns (vals (n, k) fp32 descending, idx (n, k) int32) with
    vals[i, t] = d_max − ‖x_i − x_{idx[i, t]}‖ over the k most similar
    columns (self included), ties to the lower column.  O(n·k) output; the
    dense (n, n) similarity is never materialized.

    Args:
      x: (n, d) features (cast to fp32).
      k: neighbours per row, 1 ≤ k ≤ n.
      d_max: similarity offset; defaults to 2·max‖x‖ + 1e-6.
      impl: 'auto' | 'cuda' | 'torch', as ``gains_impl`` above.
      block_m: column tile of the plain twin (the kernel uses its own).
    """
    x = x.float().contiguous()
    n = x.shape[0]
    if not 1 <= k <= n:
        raise ValueError(f"k={k} outside [1, n={n}]")
    sq = torch.sum(x * x, dim=1)
    # default: 2·max‖x‖ + 1e-6, the triangle-inequality bound on any distance
    d_max = 2.0 * torch.sqrt(torch.max(sq)) + 1e-6 if d_max is None else _scalar(d_max, x.device)
    if resolve_impl(impl, x.device) == "torch":
        return _tk.topk_sim_torch(x, sq, d_max, k, block_m=block_m)
    return _tk.topk_sim_cuda(x, sq, d_max.reshape(()).contiguous(), k)


def pairwise_l2(x: torch.Tensor, y: torch.Tensor, *, impl: str = "auto") -> torch.Tensor:
    """(n, m) fp32 pairwise distances ‖x_i − y_j‖ (the reference's formula,
    √max(‖x‖² + ‖y‖² − 2·x·y, 0)); ``impl`` as ``gains_impl`` above."""
    x = x.float().contiguous()
    y = y.float().contiguous()
    sqx = torch.sum(x * x, dim=1)
    sqy = torch.sum(y * y, dim=1)
    if resolve_impl(impl, x.device) == "torch":
        return _pw.pairwise_l2_torch(x, y, sqx, sqy)
    return _pw.pairwise_l2_cuda(x, y, sqx, sqy)


def fl_replay(
    x: torch.Tensor,
    e: torch.Tensor,
    valid: torch.Tensor,
    cur0: torch.Tensor,
    d_max,
    *,
    impl: str = "auto",
    block_m: int = 128,
) -> tuple[torch.Tensor, torch.Tensor, torch.Tensor, torch.Tensor]:
    """Sequential FL replay of an ordered candidate list (streaming finalize).

    gains[t] = Σ_i relu(s_it − max(cur0_i, max_{t'<t} s_it')) with
    s_it = d_max − ‖x_i − e_t‖: the gain sequence a greedy run records when
    it accepts the candidates in row order of ``e``.  Also the final cover
    state and each pool row's best candidate (value, position in ``e``),
    the earliest position on ties.  Dead candidates (``valid`` False) give
    no gain, no cover and never win.

    Args:
      x: (n, d) pool; e: (m, d) candidates in order (cast to fp32).
      valid: (m,) bool; cur0: (n,) fp32 initial cover; d_max: fp32 scalar.
      impl: 'auto' | 'cuda' | 'torch'; block_m: candidate block of the
        plain twin (the kernel uses its own).
    Returns:
      (gains (m,) fp32, cur (n,) fp32, best_v (n,) fp32, best_i (n,) int32).
    """
    x = x.float().contiguous()
    e = e.float().contiguous()
    sqx = torch.sum(x * x, dim=1)
    sqe = torch.sum(e * e, dim=1)
    d_max = _scalar(d_max, x.device)
    valid = valid.to(device=x.device, dtype=torch.bool)
    cur0 = cur0.float()
    if resolve_impl(impl, x.device) == "torch":
        return _fl.fl_replay_torch(x, e, sqx, sqe, valid, d_max, cur0, block_m=block_m)
    return _fl.fl_replay_cuda(x, e, sqx, sqe, valid.contiguous(), d_max.reshape(()).contiguous(),
                              cur0.contiguous())
