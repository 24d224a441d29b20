"""Greedy-sweep kernels: CUDA launch wrappers and their plain-torch twins.

Port of ``repro.kernels.fl_gains`` (``fl_gains_pallas``,
``fl_gains_argmax_pallas``, ``fl_replay_pallas``).  The TPU kernels become
hand-written CUDA sources, ``csrc/fl_gains.cu`` and ``csrc/fl_replay.cu``,
bound through :mod:`._build`; beside each launch wrapper sits the
plain-torch version of the same function: the blockwise sweep of
``repro/core/engines/device.py`` and ``repro/core/engines/features.py``,
and the blocked replay of ``repro/core/engines/streaming.py:460-505``.  The plain versions serve the CPU
and the on-card comparison; :mod:`repro_torch.kernels.ops` chooses.

Launch wrappers take pre-arranged operands (``madj = d_max − cur_max``),
check device, dtype, shape and contiguity, allocate every output with
``torch.empty``, launch on PyTorch's current stream without synchronising,
and count each launch in :data:`LAUNCHES`.
"""
from __future__ import annotations

import torch

from repro_torch.kernels import _build

__all__ = [
    "LAUNCHES",
    "fl_gains_cuda",
    "fl_gains_argmax_cuda",
    "fl_gains_torch",
    "fl_gains_argmax_torch",
    "fl_replay_cuda",
    "fl_replay_torch",
    "TILE_DTYPES",
    "PLAIN_BLOCK_M",
]

# Kernel launches per kernel (shared by every kernel module).
LAUNCHES = _build.LAUNCHES

TILE_DTYPES = {"float32": torch.float32, "bfloat16": torch.bfloat16}

# Candidates per block of the plain twin of ``fl_gains_argmax`` (the
# reference's ``DeviceConfig.block_m`` default).  Wide blocks keep the twin
# to a few large eager ops per sweep; the kernel's own block is its CTA
# width (``fl_gains_block_m()``), and the global winner does not depend on
# either.
PLAIN_BLOCK_M = 2048

_ARGMAX_ENTRY = {
    torch.float32: "fl_gains_argmax_f32",
    torch.bfloat16: "fl_gains_argmax_bf16",
}


def _require(t: torch.Tensor, what: str, dtype, shape, device) -> None:
    if t.device != device:
        raise ValueError(f"{what} is on {t.device}, expected {device}")
    if t.dtype != dtype:
        raise ValueError(f"{what} has dtype {t.dtype}, expected {dtype}")
    if tuple(t.shape) != tuple(shape):
        raise ValueError(f"{what} has shape {tuple(t.shape)}, expected {shape}")
    if not t.is_contiguous():
        raise ValueError(f"{what} must be contiguous")


def _check_operands(x, e, madj, sqx, sqe, tile_dtype, madj_name="madj"):
    if x.device.type != "cuda":
        raise ValueError(
            f"the fl_gains CUDA kernels take CUDA tensors, got {x.device}"
        )
    if x.dim() != 2 or e.dim() != 2 or x.shape[1] != e.shape[1]:
        raise ValueError(
            f"x (n, d) and e (m, d) must share d, got {tuple(x.shape)} and "
            f"{tuple(e.shape)}"
        )
    n, d = x.shape
    m = e.shape[0]
    if min(n, m, d) < 1:
        raise ValueError(f"empty operand: n={n}, m={m}, d={d}")
    if max(n * d, m * d) >= 2**31:
        raise ValueError("operands past 2**31 elements are not supported")
    dev = x.device
    _require(x, "x", tile_dtype, (n, d), dev)
    _require(e, "e", tile_dtype, (m, d), dev)
    _require(madj, madj_name, torch.float32, (n,), dev)
    _require(sqx, "sqx", torch.float32, (n,), dev)
    _require(sqe, "sqe", torch.float32, (m,), dev)
    return n, m, d


def _stream(device: torch.device) -> int:
    return torch.cuda.current_stream(device).cuda_stream


def fl_gains_cuda(x, e, madj, sqx, sqe) -> torch.Tensor:
    """Launch the fused gains sweep: gains[c] = Σ_i relu(madj_i − ‖x_i − e_c‖).

    Args:
      x: (n, d) fp32 pool, e: (m, d) fp32 candidates (CUDA, contiguous).
      madj: (n,) fp32 d_max − cur_max; sqx (n,), sqe (m,) fp32 squared norms.
    Returns:
      (m,) fp32 gains.
    """
    n, m, d = _check_operands(x, e, madj, sqx, sqe, torch.float32)
    lib = _build.library("fl_gains")
    gains = torch.empty((m,), dtype=torch.float32, device=x.device)
    status = lib.fl_gains_f32(
        x.data_ptr(), e.data_ptr(), madj.data_ptr(), sqx.data_ptr(),
        sqe.data_ptr(), gains.data_ptr(), n, m, d, _stream(x.device),
    )
    _build.check(status, "fl_gains")
    LAUNCHES["fl_gains"] += 1
    return gains


def fl_gains_argmax_cuda(x, e, madj, sqx, sqe, chosen):
    """Launch the fused sweep with its per-block argmax epilogue.

    Args:
      x: (n, d), e: (m, d) tiles, both fp32 or both bf16 (CUDA, contiguous).
      madj: (n,) fp32; sqx (n,), sqe (m,) fp32 squared norms of the fp32
        features; chosen: (m,) bool, columns that must not win.
    Returns:
      (gains (m,) fp32 un-penalized, part_g (m_blocks,) fp32,
      part_i (m_blocks,) int32): each candidate block's best penalized gain
      and its index, lowest index on ties; the block width is the kernel's
      own (``fl_gains_block_m()``).  A block whose every column is chosen
      reports part_g ≤ −1e29.
    """
    entry = _ARGMAX_ENTRY.get(x.dtype)
    if entry is None:
        raise ValueError(f"unsupported tile dtype {x.dtype}")
    n, m, d = _check_operands(x, e, madj, sqx, sqe, x.dtype)
    _require(chosen, "chosen", torch.bool, (m,), x.device)
    lib = _build.library("fl_gains")
    m_blocks = -(-m // lib.fl_gains_block_m())
    gains = torch.empty((m,), dtype=torch.float32, device=x.device)
    part_g = torch.empty((m_blocks,), dtype=torch.float32, device=x.device)
    part_i = torch.empty((m_blocks,), dtype=torch.int32, device=x.device)
    status = getattr(lib, entry)(
        x.data_ptr(), e.data_ptr(), madj.data_ptr(), sqx.data_ptr(),
        sqe.data_ptr(), chosen.data_ptr(), gains.data_ptr(),
        part_g.data_ptr(), part_i.data_ptr(), n, m, d, _stream(x.device),
    )
    _build.check(status, "fl_gains_argmax")
    LAUNCHES["fl_gains_argmax"] += 1
    return gains, part_g, part_i


def _block_gains(x_t, e_t, sqx, sqe, cur_max, d_max) -> torch.Tensor:
    """Σ_i relu((d_max − ‖x_i − e_c‖) − cur_max_i) for one candidate block,
    in the reference's jnp order (similarity first, then the cover state)."""
    dots = x_t.float() @ e_t.float().T  # (n, bm); bf16 tiles widen exactly
    d2 = sqx[:, None] + sqe[None, :] - 2.0 * dots
    s = d_max - torch.sqrt(torch.clamp(d2, min=0.0))
    return torch.sum(torch.clamp(s - cur_max[:, None], min=0.0), dim=0)


def fl_gains_torch(x, e, cur_max, sqx, sqe, d_max, *, block_m: int = 512):
    """Plain twin of :func:`fl_gains_cuda` (``features.py:85-95``): the same
    gains, candidate block by candidate block.  The last block is ragged
    rather than wrapped onto valid rows; the (m,) gains are the same."""
    m = e.shape[0]
    out = [
        _block_gains(x, e[lo:lo + block_m], sqx, sqe[lo:lo + block_m],
                     cur_max, d_max)
        for lo in range(0, m, block_m)
    ]
    return torch.cat(out)


def fl_gains_argmax_torch(
    x, e, cur_max, sqx, sqe, d_max, chosen, *, block_m: int = PLAIN_BLOCK_M
):
    """Plain twin of :func:`fl_gains_argmax_cuda` (``device.py:137-158``).

    ``x`` and ``e`` are the feature tiles (fp32 or bf16); the additive
    −1e30 penalty on chosen columns and the lowest-index tie rule within a
    block match the kernel.  Returns (gains, part_g, part_i) with blocks of
    ``block_m`` candidates (:data:`PLAIN_BLOCK_M` unless a caller asks for
    another width; the global winner does not depend on it).
    """
    m = e.shape[0]
    pen = torch.where(chosen, -1e30, 0.0).to(torch.float32)
    gains, part_g, part_i = [], [], []
    for lo in range(0, m, block_m):
        hi = min(lo + block_m, m)
        g = _block_gains(x, e[lo:hi], sqx, sqe[lo:hi], cur_max, d_max)
        gp = g + pen[lo:hi]
        p = torch.argmax(gp)  # first maximum: lowest index on ties
        gains.append(g)
        part_g.append(gp[p])
        part_i.append((lo + p).to(torch.int32))
    return torch.cat(gains), torch.stack(part_g), torch.stack(part_i)


def fl_replay_cuda(x, e, sqx, sqe, valid, d_max, cur0):
    """Launch the sequential replay of the ordered candidates ``e``.

    Args:
      x: (n, d) fp32 pool, e: (m, d) fp32 candidates in replay order (CUDA,
        contiguous); sqx (n,), sqe (m,) fp32 squared norms.
      valid: (m,) bool, False for a dead candidate; d_max: 0-d fp32 tensor;
      cur0: (n,) fp32 initial cover state.
    Returns:
      (gains (m,) fp32, cur (n,) fp32, best_v (n,) fp32, best_i (n,) int32);
      gains are the partials of each block of ``fl_replay_block_rows()``
      (64) pool rows summed over axis 0; a CTA of the kernel owns 128 rows
      and writes two such partials, so the sum keeps the order and the bits
      of a 64-row partition.
    """
    if x.device.type != "cuda":
        raise ValueError(f"the fl_replay CUDA kernel takes CUDA tensors, got {x.device}")
    n, m, d = _check_operands(x, e, cur0, sqx, sqe, torch.float32, "cur0")
    dev = x.device
    _require(valid, "valid", torch.bool, (m,), dev)
    _require(d_max, "d_max", torch.float32, (), dev)
    lib = _build.library("fl_replay")
    n_blocks = -(-n // lib.fl_replay_block_rows())
    part = torch.empty((n_blocks, m), dtype=torch.float32, device=dev)
    cur = torch.empty((n,), dtype=torch.float32, device=dev)
    best_v = torch.empty((n,), dtype=torch.float32, device=dev)
    best_i = torch.empty((n,), dtype=torch.int32, device=dev)
    status = lib.fl_replay_f32(
        x.data_ptr(), e.data_ptr(), sqx.data_ptr(), sqe.data_ptr(),
        valid.data_ptr(), d_max.data_ptr(), cur0.data_ptr(), part.data_ptr(),
        cur.data_ptr(), best_v.data_ptr(), best_i.data_ptr(), n, m, d,
        _stream(dev),
    )
    _build.check(status, "fl_replay")
    LAUNCHES["fl_replay"] += 1
    return part.sum(dim=0), cur, best_v, best_i


def fl_replay_torch(x, e, sqx, sqe, valid, d_max, cur0, *, block_m: int = 128):
    """Plain twin of :func:`fl_replay_cuda` (``streaming.py:460-505``): one
    (n × block_m) similarity tile per candidate block, the cover state
    before each column from a running max along the block."""
    n = x.shape[0]
    m = e.shape[0]
    dead = torch.tensor(-1e30, dtype=torch.float32, device=x.device)
    cur = cur0.float()
    best_v = torch.full((n,), -1e30, dtype=torch.float32, device=x.device)
    best_i = torch.zeros((n,), dtype=torch.int32, device=x.device)
    gains = []
    for lo in range(0, m, block_m):
        hi = min(lo + block_m, m)
        d2 = (sqx[:, None] + sqe[None, lo:hi]) - 2.0 * (x @ e[lo:hi].T)
        s = d_max - torch.sqrt(torch.clamp(d2, min=0.0))
        s_cov = torch.where(valid[None, lo:hi], s, dead)
        run = torch.cummax(s_cov, dim=1).values
        prev = torch.maximum(
            cur[:, None], torch.cat([dead.expand(n, 1), run[:, :-1]], dim=1)
        )
        gains.append(torch.clamp(s_cov - prev, min=0.0).sum(dim=0))
        cur = torch.maximum(cur, run[:, -1])
        bvb, bib = torch.max(s_cov, dim=1)  # first maximum, as jnp.argmax
        upd = bvb > best_v  # strict: the earlier block wins ties
        best_v = torch.where(upd, bvb, best_v)
        best_i = torch.where(upd, (bib + lo).to(torch.int32), best_i)
    gains = torch.cat(gains) if gains else torch.zeros((0,), device=x.device)
    return gains, cur, best_v, best_i
