"""Loops of like iterations, and how a dry run counts them (no counterpart
in ``repro``: the reference's loops are ``lax.scan``s, which XLA costs
once per body).

The port's Python loops over sequence steps (the sLSTM), chunks (the
mLSTM, blockwise attention) and microbatches (``train/train_step.py``)
run every iteration.  A dry run that traces a step on fake tensors
(``launch/dryrun.py``) cannot afford that: an sLSTM step costs ~70 ms of
host time to trace with its backward, and xlstm-1.3b's ``train_4k`` cell
has 4,096 a layer.  So while a dry run has installed a counter,
:func:`steps` runs three iterations alone, the first, the second and the
last, and has the second counted for the n − 2 in the middle: the first
starts from constants that need no gradient, the last carries a state
that nothing reads (so its backward skips the state's update), and every
one between repeats the second's shapes and work, forward and backward.
:func:`widen` then grows a loop's stacked outputs back to n along the
loop axis, so the code after the loop sees the real shapes.  With no
counter installed both are the plain loop and the identity.
"""
from __future__ import annotations

import contextlib
from typing import Callable, ContextManager, Iterator

import torch

__all__ = ["steps", "widen", "counting"]

# set by a dry run: n → a context in which every op counts n times,
# yielding a callable to run after the loop
_COUNT: Callable[[int], ContextManager] | None = None


@contextlib.contextmanager
def counting(count: Callable[[int], ContextManager]):
    """Install ``count`` for the duration of the block (one at a time)."""
    global _COUNT
    if _COUNT is not None:
        raise RuntimeError("a loop counter is already installed")
    _COUNT = count
    try:
        yield
    finally:
        _COUNT = None


def steps(n: int) -> Iterator[int]:
    """``range(n)``; under an installed counter, 0, 1 and n − 1 alone, with
    the body's work at 1 counted n − 2 times.  The counter's context yields
    a callable run once the loop is over: what iteration 1 made and is
    still alive then (saved for the backward, collected) stands for n − 2
    copies; what iteration n − 1 replaced (a carried state) for one."""
    if _COUNT is None or n <= 3:
        yield from range(n)
        return
    yield 0
    with _COUNT(n - 2) as settle:
        yield 1
    yield n - 1
    settle()


def widen(x: torch.Tensor, dim: int, n: int) -> torch.Tensor:
    """``x`` with its size along ``dim`` grown to ``n`` by repeating its last
    slice (``x`` itself when it already has ``n``: always, outside a dry
    run)."""
    m = x.shape[dim]
    if m == n:
        return x
    shape = list(x.shape)
    shape[dim] = n - m
    return torch.cat([x, x.narrow(dim, m - 1, 1).expand(shape)], dim=dim)
