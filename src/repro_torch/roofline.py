"""Roofline analysis over the dry-run artifacts: one H100, or one device
of the reference's 16×16 and 2×16×16 meshes.

Port of ``repro.roofline``.  Workflow: ``python -m
repro_torch.launch.dryrun --all --probes`` writes the artifacts,
``python -m repro_torch.roofline [--markdown|--compare DIR]`` reports on
them.  (The reference's ``scripts/finalize_experiments.py`` publishes
into its own ``EXPERIMENTS.md`` and has no port.)

Methodology
-----------
The port's dry run traces every layer (no scan counts a body once), but
a full-depth trace of a deep model costs host time, so the sweep also
traces, per (arch × shape), two probes of 1 and 2 pattern periods (one
microbatch) and extrapolates as the reference does:

    X(full) ≈ X(p1) + (n_layers/period − 1) · (X(p2) − X(p1))

which is exact for the homogeneous layer stack (``tests/test_torch_roofline.py``
holds it to a full trace) and carries embedding, head and optimizer
costs in the p1 intercept.

Roofline terms (one device, one step; published dense peaks by card name,
:data:`CARDS`):

    compute    = bf16 FLOPs / 989e12 + fp32 FLOPs / 67e12
                 [tensor cores; CUDA cores — the port runs with TF32 off]
    memory     = bytes accessed / 3.35e12        [HBM3]
    collective = Σ collective bytes / 450e9      [NVLink, a direction; 0 on one card]

On a mesh (``--mesh 16x16`` or ``2x16x16``, or ``single``/``multi``) every
count is one device's and the collective bytes are the output bytes of
the collectives it issues (``launch/dryrun.py``'s census).  The collective
term prices them all at NVLink's rate, though a 16-wide ``model`` axis
spans two 8-card NVLink domains of H100 nodes and the ``data`` and ``pod``
axes cross nodes over the network: it is a lower bound, not a model of
the fabric.

With every FLOP in bf16 the compute term is the reference's formula.
MODEL_FLOPS = 6·N·D (train) or 2·N·D (inference), N = active params.
``fits`` compares the reckoned peak bytes with the device memory the
artifact records.
"""
from __future__ import annotations

import argparse
import glob
import json
import os
from dataclasses import dataclass

# Published dense peaks (NVIDIA data sheet, H100 SXM), keyed by the name
# torch.cuda.get_device_name gives: fp32 on the CUDA cores, bf16 on the
# tensor cores, device-memory and NVLink (one direction) bandwidth, and
# the published memory (for artifacts traced without the card).
CARDS = {
    "NVIDIA H100 80GB HBM3": {"fp32": 67e12, "bf16": 989e12, "hbm": 3.35e12,
                              "link": 450e9, "memory_bytes": 80e9},
}
CARD = "NVIDIA H100 80GB HBM3"
# (fp32 FLOP/s, bf16 FLOP/s, bytes/s) by card name, for the kernels' bounds
PEAKS = {k: (v["fp32"], v["bf16"], v["hbm"]) for k, v in CARDS.items()}
MESH = "h100x1"
# --mesh → the artifacts' mesh tag (the reference's names, and the tags)
MESH_TAGS = {MESH: MESH, "single": "16x16", "multi": "2x16x16", "16x16": "16x16",
             "2x16x16": "2x16x16"}

ARTIFACT_DIR = os.path.join(os.path.dirname(__file__), "../../artifacts/dryrun_torch")

__all__ = ["CARDS", "CARD", "PEAKS", "MESH", "MESH_TAGS", "CellRoofline", "roofline_terms", "analyze_cell",
           "analyze_all", "to_markdown", "compare_markdown", "main"]


@dataclass
class CellRoofline:
    arch: str
    shape: str
    mesh: str
    step: str
    flops: float  # per device per step (extrapolated)
    flops_bf16: float
    flops_fp32: float
    hbm_bytes: float
    coll_bytes: float
    t_compute: float
    t_memory: float
    t_collective: float
    dominant: str
    model_flops_per_dev: float
    useful_ratio: float  # MODEL_FLOPS / traced FLOPs
    mfu_bound: float  # model_flops / (t_dominant · bf16 peak)
    fits_hbm: bool
    mem_gb: float
    note: str
    extrapolated: bool

    @property
    def t_dominant(self) -> float:
        return max(self.t_compute, self.t_memory, self.t_collective)


def _load(out_dir: str, arch: str, shape: str, mesh: str, probe: int = 0):
    suffix = f"__p{probe}" if probe else ""
    path = os.path.join(out_dir, f"{arch}__{shape}__{MESH_TAGS[mesh]}{suffix}.json")
    if not os.path.exists(path):
        return None
    with open(path) as f:
        return json.load(f)


def _coll_total(rec: dict) -> float:
    return float(rec.get("collective_bytes_total", 0))


def _periods(arch: str) -> float:
    from repro_torch.configs.registry import get_config

    cfg = get_config(arch)
    return cfg.n_layers / len(cfg.block_pattern)


def analyze_cell(out_dir: str, arch: str, shape: str, mesh: str = MESH) -> CellRoofline | None:
    """The cell's roofline: FLOPs and bytes from the probes' extrapolation
    where both are there, else from the full-depth artifact; memory from
    the full-depth artifact, else the probes' extrapolation at one
    microbatch (an upper bound for a microbatched train step).  A probe
    pair alone suffices: a full trace of a deep model costs host time."""
    full = _load(out_dir, arch, shape, mesh)
    p1 = _load(out_dir, arch, shape, mesh, probe=1)
    p2 = _load(out_dir, arch, shape, mesh, probe=2)
    probed = bool(p1 and p2 and p1.get("status") == "ok" and p2.get("status") == "ok")
    if (full is None or full.get("status") != "ok") and not probed:
        return None
    base = full if full is not None and full.get("status") == "ok" else p1

    if probed:
        periods = _periods(arch)

        def extrap(key_fn):
            a, b = key_fn(p1), key_fn(p2)
            return a + (periods - 1) * (b - a)

        flops16 = extrap(lambda r: r["cost"].get("flops_bf16", r["cost"].get("flops", 0.0)))
        flops32 = extrap(lambda r: r["cost"].get("flops_fp32", 0.0))
        hbm = extrap(lambda r: r["cost"].get("bytes accessed", 0.0))
        coll = extrap(_coll_total)
        mem_bytes = extrap(lambda r: _mem_bytes(r)) if base is p1 else _mem_bytes(full)
    else:
        flops16 = full["cost"].get("flops_bf16", full["cost"].get("flops", 0.0))
        flops32 = full["cost"].get("flops_fp32", 0.0)
        hbm = full["cost"].get("bytes accessed", 0.0)
        coll = _coll_total(full)
        mem_bytes = _mem_bytes(full)

    card = base.get("card", {}).get("name", CARD)
    peak = CARDS.get(card, CARDS[CARD])
    n_dev = base.get("n_devices", 1)
    model_flops_dev = base["model_flops"] / n_dev
    flops = flops16 + flops32
    terms = roofline_terms(flops16, flops32, hbm, coll, card)
    t_c, t_m, t_x = terms["compute"], terms["memory"], terms["collective"]
    dominant = max(terms, key=terms.get)
    t_dom = terms[dominant]
    useful = model_flops_dev / max(flops, 1e-9)
    mfu_bound = model_flops_dev / max(t_dom, 1e-12) / peak["bf16"]
    memory = base.get("card", {}).get("memory_bytes", peak["memory_bytes"])
    return CellRoofline(
        arch=arch,
        shape=shape,
        mesh=MESH_TAGS[mesh],
        step=base.get("meta", {}).get("step", "?"),
        flops=flops,
        flops_bf16=flops16,
        flops_fp32=flops32,
        hbm_bytes=hbm,
        coll_bytes=coll,
        t_compute=t_c,
        t_memory=t_m,
        t_collective=t_x,
        dominant=dominant,
        model_flops_per_dev=model_flops_dev,
        useful_ratio=useful,
        mfu_bound=mfu_bound,
        fits_hbm=mem_bytes <= memory,
        mem_gb=mem_bytes / 2**30,
        note=_note(dominant, terms, useful, base, flops32 / max(flops, 1e-9)),
        extrapolated=probed,
    )


def roofline_terms(flops_bf16: float, flops_fp32: float, hbm_bytes: float,
                   coll_bytes: float = 0.0, card: str = CARD) -> dict:
    """{compute, memory, collective} seconds of one step on ``card``."""
    peak = CARDS.get(card, CARDS[CARD])
    return {"compute": flops_bf16 / peak["bf16"] + flops_fp32 / peak["fp32"],
            "memory": hbm_bytes / peak["hbm"], "collective": coll_bytes / peak["link"]}


def _mem_bytes(rec: dict) -> float:
    mem = rec.get("memory", {})
    return mem.get("argument_size_in_bytes", 0) + mem.get("temp_size_in_bytes", 0)


def _note(dominant: str, terms: dict, useful: float, rec: dict, fp32_share: float) -> str:
    shape = rec["shape"]
    if dominant == "collective":
        return ("collective bound — the device's collectives outlast its compute and HBM "
                "traffic at NVLink's rate; reshard, or overlap them")
    if dominant == "memory":
        if "decode" in shape or "500k" in shape:
            return ("cache/weight streaming bound (expected for decode) — raise the batch or "
                    "serve bf16 weights to lift arithmetic intensity")
        return ("HBM-traffic bound — eager ops each read and write their operands; fusing "
                "elementwise chains would cut the bytes")
    if fp32_share > 0.5:
        return ("compute-bound on the CUDA cores — fp32 products (recurrences, gates) run at "
                "67 TFLOP/s; bf16 would take the tensor cores")
    if useful < 0.35:
        return ("compute-bound but low useful ratio — remat recompute and non-model products "
                "dominate; relax remat policy or fuse")
    return "compute-bound near the tensor-core roof — healthy"


def analyze_all(out_dir: str | None = None, mesh: str = MESH) -> list[CellRoofline]:
    out_dir = out_dir or os.path.normpath(ARTIFACT_DIR)
    keys = set()
    for path in glob.glob(os.path.join(out_dir, f"*__{MESH_TAGS[mesh]}.json")) + glob.glob(
            os.path.join(out_dir, f"*__{MESH_TAGS[mesh]}__p*.json")):
        base = os.path.basename(path)[:-len(".json")]
        arch, shape = base.split("__")[:2]
        keys.add((arch, shape))
    cells = []
    for arch, shape in sorted(keys):
        cell = analyze_cell(out_dir, arch, shape, mesh)
        if cell:
            cells.append(cell)
    return cells


def to_markdown(cells: list[CellRoofline]) -> str:
    hdr = (
        "| arch | shape | step | compute s | memory s | collective s | "
        "dominant | useful | MFU-bound | mem GB | fits |\n"
        "|---|---|---|---|---|---|---|---|---|---|---|\n"
    )
    rows = []
    for c in cells:
        rows.append(
            f"| {c.arch} | {c.shape} | {c.step} | {c.t_compute:.3e} | "
            f"{c.t_memory:.3e} | {c.t_collective:.3e} | **{c.dominant}** | "
            f"{c.useful_ratio:.2f} | {c.mfu_bound:.2f} | {c.mem_gb:.1f} | "
            f"{'✓' if c.fits_hbm else '✗'} |"
        )
    return hdr + "\n".join(rows)


def compare_markdown(base_dir: str, opt_dir: str, mesh: str = MESH) -> str:
    """Baseline against optimized, side by side."""
    base = {(c.arch, c.shape): c for c in analyze_all(base_dir, mesh)}
    opt = {(c.arch, c.shape): c for c in analyze_all(opt_dir, mesh)}
    hdr = (
        "| arch | shape | dominant (base→opt) | t_dom base s | t_dom opt s | "
        "speedup | MFU-bound base | MFU-bound opt |\n"
        "|---|---|---|---|---|---|---|---|\n"
    )
    rows = []
    for key in sorted(opt):
        o = opt[key]
        b = base.get(key)
        if b is None:
            continue
        rows.append(
            f"| {o.arch} | {o.shape} | {b.dominant}→{o.dominant} | "
            f"{b.t_dominant:.3e} | {o.t_dominant:.3e} | "
            f"**{b.t_dominant / max(o.t_dominant, 1e-12):.1f}x** | "
            f"{b.mfu_bound:.3f} | {o.mfu_bound:.3f} |"
        )
    return hdr + "\n".join(rows)


def main(argv=None) -> None:
    ap = argparse.ArgumentParser()
    ap.add_argument("--out", default=os.path.normpath(ARTIFACT_DIR))
    ap.add_argument("--mesh", default=MESH, choices=sorted(MESH_TAGS))
    ap.add_argument("--markdown", action="store_true")
    ap.add_argument("--compare", default=None,
                    help="baseline artifact dir — emit baseline-vs-optimized markdown")
    args = ap.parse_args(argv)
    if args.compare:
        print(compare_markdown(args.compare, args.out, args.mesh))
        return
    cells = analyze_all(args.out, args.mesh)
    if args.markdown:
        print(to_markdown(cells))
        return
    for c in cells:
        print(
            f"{c.arch:24s} {c.shape:12s} {c.step:12s} "
            f"C={c.t_compute:.2e} M={c.t_memory:.2e} X={c.t_collective:.2e} "
            f"dom={c.dominant:10s} useful={c.useful_ratio:5.2f} "
            f"mfu≤{c.mfu_bound:5.2f} mem={c.mem_gb:6.1f}GB"
            f"{'' if c.extrapolated else ' (no-probe)'}"
        )
        print(f"{'':24s} → {c.note}")


if __name__ == "__main__":
    main()
