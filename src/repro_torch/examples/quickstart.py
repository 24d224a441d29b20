"""Quickstart: CRAIG in 60 seconds (paper Fig. 1, miniature), on the card.

Port of ``examples/quickstart.py``.  Selects a 10% weighted coreset of a
logistic-regression dataset with the greedy facility-location selector,
trains with weighted incremental gradient descent (paper Eq. 20), and
compares against full-data and random-subset training.

Run:  PYTHONPATH=src python -m repro_torch.examples.quickstart
      PYTHONPATH=src python -m repro_torch.examples.quickstart --n 49990 --d 22
      PYTHONPATH=src python -m repro_torch.examples.quickstart --device cpu

fp32 matrix products run in full fp32 (TF32 off), as the reference's do.
"""
from __future__ import annotations

import argparse
import math
import time

import numpy as np
import torch

from repro_torch._device import resolve_device
from repro_torch.core.craig import CraigConfig, CraigSelector
from repro_torch.core.proxy import convex_feature_proxy
from repro_torch.data.synthetic import make_classification
from repro_torch.optim import ig_run

LAM = 1e-5


def logistic(x: torch.Tensor, y01: np.ndarray, lam: float = LAM):
    """Per-example gradient oracle and full loss of L2-regularized logistic
    regression on (x, y ∈ {0, 1})."""
    ybin = torch.as_tensor(y01 * 2.0 - 1.0, dtype=torch.float32, device=x.device)

    def grad_one(w, i):
        s = torch.sigmoid(-ybin[i] * (x[i] @ w))
        return -s * ybin[i] * x[i] + lam * w

    def full_loss(w) -> float:
        z = -ybin * (x @ w)
        return float(torch.mean(torch.log1p(torch.exp(z))) + 0.5 * lam * (w @ w))

    return grad_one, full_loss


def schedule_for(n: int):
    """The reference's step sizes: α_k = 2 / (n·(1 + 0.2k))."""
    return lambda k: 2.0 / (n * (1 + 0.2 * k))


def main(argv=None) -> None:
    p = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    p.add_argument("--n", type=int, default=1500)
    p.add_argument("--d", type=int, default=20)
    p.add_argument("--epochs", type=int, default=25)
    p.add_argument("--device", default="cuda")
    args = p.parse_args(argv)
    dev = resolve_device(args.device)
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    n, d = args.n, args.d

    x, y = make_classification(n, d, 2, seed=0)
    x = x / np.abs(x).max()
    X = convex_feature_proxy(x, device=dev)
    grad_one, full_loss = logistic(X, y)
    sched = schedule_for(n)

    # 1) CRAIG selection: per-class facility location over feature proxies
    t0 = time.perf_counter()
    cs = CraigSelector(CraigConfig(fraction=0.1, per_class=True), device=dev).select(X, y)
    print(f"selected {cs.size}/{n} examples in {time.perf_counter()-t0:.2f}s "
          f"on {dev} with engine {cs.engine['name']} "
          f"(γ sums to {cs.weights.sum():.0f}, ε̂={cs.epsilon_hat:.2f})")

    # 2) train three ways
    runs = {
        "full": (np.arange(n), np.ones(n, np.float32)),
        "craig": (cs.indices, cs.weights),
        "random": (
            np.random.RandomState(0).choice(n, cs.size, replace=False),
            np.full(cs.size, n / cs.size, np.float32),
        ),
    }
    print(f"\n{'arm':8s} {'final loss':>11s} {'grad evals':>11s}")
    for name, (idx, w) in runs.items():
        t0 = time.perf_counter()
        wgt, _ = ig_run(
            grad_one, torch.zeros(d, device=dev), idx, w, sched, args.epochs
        )
        print(f"{name:8s} {full_loss(wgt):11.4f} {args.epochs*len(idx):11d}"
              f"   ({time.perf_counter()-t0:.2f}s)")
    print(f"\nloss at w0 = log 2 = {math.log(2):.4f}; "
          "CRAIG ≈ full-data loss at ~10% of the gradient evaluations.")


if __name__ == "__main__":
    main()
