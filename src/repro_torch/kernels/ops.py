"""Public kernel wrappers: dispatch and input checks.

Port of ``repro.kernels.ops`` (``fl_gains``, ``fl_gains_argmax``,
``ce_proxy``).  The reference pads to block and lane multiples and picks
Pallas interpret mode off the TPU; here the CUDA kernels mask ragged edges
themselves, so the wrappers only arrange operands and dispatch
(``gains_impl``, or ``impl`` for ``ce_proxy``):

  * ``'auto'``: the CUDA kernel for CUDA tensors, the plain twin for CPU
    tensors;
  * ``'cuda'``: the kernel; raises for tensors that are not on a card;
  * ``'torch'``: the plain twin, on whatever device the tensors are.

Nothing falls back: a kernel that fails to build or launch raises.
:data:`LAUNCHES` counts kernel launches per kernel.
"""
from __future__ import annotations

import torch

from repro_torch.kernels import _build
from repro_torch.kernels import ce_proxy as _ce
from repro_torch.kernels import fl_gains as _fl

__all__ = ["fl_gains", "fl_gains_argmax", "ce_proxy", "resolve_impl", "LAUNCHES",
           "TILE_DTYPES"]

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
        On a card the bf16 kernel is the production route (D ≤ 2048).
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
        return _ce.ce_proxy_torch(hidden, unembed, labels, vv, compute_dtype)
    return _ce.ce_proxy_cuda(
        hidden.to(compute_dtype).contiguous(), unembed.to(compute_dtype).contiguous(),
        labels.to(torch.int32).contiguous(), vv,
    )
