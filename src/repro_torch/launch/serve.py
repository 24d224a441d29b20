"""Serving launcher: batched greedy decoding of a registered architecture,
or the coreset service behind a JSON-lines protocol.

Port of ``repro.launch.serve``.  Decode mode (seeded weights, prompts
drawn from a seeded generator):

    PYTHONPATH=src python -m repro_torch.launch.serve --arch qwen3-1.7b --smoke \
        --batch 4 --prompt-len 16 --new 32
    PYTHONPATH=src python -m repro_torch.launch.serve --arch qwen3-1.7b --smoke --device cpu

Coreset-as-a-service mode: one JSON request per stdin line, one JSON
response per stdout line:

    PYTHONPATH=src python -m repro_torch.launch.serve --coreset --budget 32 --dim 8
    PYTHONPATH=src python -m repro_torch.launch.serve --coreset --device cpu

    {"op": "delta", "feats": [[...], ...], "labels": [...]?}
        -> {"ok": true, "version": v, "n_seen": n}
    {"op": "coreset"}
        -> {"ok": true, "version": v, "indices": [...], "gamma": [...],
            "n_seen": n, "n_live": l, "coverage": c}
    {"op": "quit"}   -> {"ok": true, "bye": true}
    anything invalid -> {"ok": false, "error": "..."}   (service keeps running)

Both modes run on ``--device`` (default ``cuda``).  In service mode a
fault plan in ``$REPRO_FAULT_PLAN`` (``repro_torch.faults``, JSON) is
installed at start-up.  ``--arch`` takes any registered architecture;
as in the reference, a stub modality frontend (qwen2-vl-7b) is swapped
to tokens, and codebook heads (musicgen-medium) are refused with a
``ValueError`` (``launch.train.launch_config``).  What a serving cell
costs before it runs — memory, FLOPs, bytes, roofline bound — is
``launch/dryrun.py``'s to reckon (``--shape decode_32k long_500k``).
"""
from __future__ import annotations

import argparse
import json
import sys
import time

import torch

from repro_torch._device import resolve_device
from repro_torch.configs import ARCHS
from repro_torch.core.engines import StreamingConfig
from repro_torch.faults import FailurePolicy, install_from_env
from repro_torch.launch.train import launch_config
from repro_torch.models import init_params
from repro_torch.serve import CoresetService, greedy_generate


def _serve_coreset(args, stdin=None, stdout=None) -> None:
    """JSON-lines loop over a CoresetService (sync mode: the response to a
    delta is written once its drain has published)."""
    install_from_env()  # a parent arms the service through $REPRO_FAULT_PLAN
    stdin = sys.stdin if stdin is None else stdin
    stdout = sys.stdout if stdout is None else stdout
    svc = CoresetService(
        args.budget,
        args.dim,
        config=StreamingConfig(eps=args.eps, levels=args.levels),
        metric=args.metric,
        per_class=args.per_class,
        mode="sync",
        evict=args.evict,
        failure_policy=FailurePolicy(
            max_retries=args.ingest_retries,
            backoff_base_s=args.ingest_backoff_s,
            on_exhaustion=args.on_exhaustion,
        ),
        device=args.device,
    )

    def reply(obj: dict) -> None:
        stdout.write(json.dumps(obj) + "\n")
        stdout.flush()

    for line in stdin:
        line = line.strip()
        if not line:
            continue
        try:
            req = json.loads(line)
            op = req.get("op")
            if op == "delta":
                version = svc.submit_delta(req["feats"], req.get("labels"))
                failure = svc.pop_failure()
                if failure is not None:
                    # keep_stale abandonment: the installed selection is
                    # unchanged; say so instead of letting the version stall
                    reply({"ok": False, "n_seen": svc.n_seen, **failure})
                else:
                    reply({"ok": True, "version": version, "n_seen": svc.n_seen})
            elif op == "coreset":
                u = svc.coreset(block=True)
                if u is None:
                    reply({"ok": False, "error": "no deltas ingested yet"})
                else:
                    reply({
                        "ok": True,
                        "version": u.version,
                        "indices": u.indices.tolist(),
                        "gamma": u.weights.tolist(),
                        "n_seen": u.n_seen,
                        "n_live": u.n_live,
                        "coverage": u.coverage,
                    })
            elif op == "quit":
                reply({"ok": True, "bye": True})
                return
            else:
                reply({"ok": False, "error": f"unknown op {op!r}"})
        except Exception as e:  # noqa: BLE001 — protocol errors go to the client
            reply({"ok": False, "error": f"{type(e).__name__}: {e}"})


def _serve_decode(args) -> torch.Tensor:
    """Greedy decoding of ``--batch`` seeded prompts; returns the tokens."""
    device = resolve_device(args.device)
    cfg = launch_config(args.arch, args.smoke)
    params = init_params(cfg, torch.Generator(device=device).manual_seed(0))
    prompts = torch.randint(0, cfg.vocab_size, (args.batch, args.prompt_len),
                            generator=torch.Generator().manual_seed(1)).to(device)
    t0 = time.perf_counter()
    out = greedy_generate(params, cfg, prompts, max_new=args.new)
    sample = out[0, args.prompt_len:args.prompt_len + 12].tolist()  # waits for the device
    dt = time.perf_counter() - t0
    n_tok = args.batch * (args.prompt_len + args.new)
    print(f"{cfg.name}: {tuple(out.shape)} in {dt:.2f}s ({n_tok / dt:.0f} tok/s) "
          f"on {device}")
    print("sample:", sample)
    return out


def main(argv=None):
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--arch", choices=sorted(ARCHS),
                    help="decode mode: a registered architecture")
    ap.add_argument("--smoke", action="store_true",
                    help="reduced same-family config (CPU-runnable)")
    ap.add_argument("--batch", type=int, default=4)
    ap.add_argument("--prompt-len", type=int, default=16)
    ap.add_argument("--new", type=int, default=32)
    ap.add_argument("--coreset", action="store_true",
                    help="run the JSON-lines coreset service instead of decode")
    ap.add_argument("--device", default="cuda")
    ap.add_argument("--budget", type=int, default=32)
    ap.add_argument("--dim", type=int, default=8)
    ap.add_argument("--metric", default="l2", choices=("l2", "cosine"))
    ap.add_argument("--per-class", action="store_true")
    ap.add_argument("--eps", type=float, default=0.15)
    ap.add_argument("--levels", type=int, default=0)
    ap.add_argument("--evict", action="store_true",
                    help="bounded-memory mode: drop pool rows no sieve "
                         "references after every drain (O(L·k·d) state)")
    ap.add_argument("--ingest-retries", type=int, default=0,
                    help="retries per ingest drain before the exhaustion policy applies")
    ap.add_argument("--ingest-backoff-s", type=float, default=0.05,
                    help="base of the exponential retry backoff")
    ap.add_argument("--on-exhaustion", default="raise", choices=("raise", "keep_stale"),
                    help="'raise' fails the request; 'keep_stale' keeps serving the "
                         "installed selection and replies with a craig_refresh_failed event")
    args = ap.parse_args(argv)
    if args.coreset:
        _serve_coreset(args)
        return None
    if args.arch is None:
        ap.error("--arch is required unless --coreset is given")
    return _serve_decode(args)


if __name__ == "__main__":
    main()
