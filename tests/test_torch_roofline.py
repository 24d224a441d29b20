"""The port's roofline (``roofline.py``) against the reference's
(``repro.roofline``) on synthetic artifact sets.

With every FLOP in bf16, the reference's module constants set to the
H100's peaks (the test monkeypatches them; the reference is not edited)
and the artifacts' device memory at the reference's 16 GiB, the port's
``analyze_cell`` gives the reference's numbers: the p1/p2 extrapolation,
the three terms, the dominant one, the useful ratio, the MFU bound and
``fits``.  fp32 FLOPs take the CUDA cores' 67 TFLOP/s.
"""
import json

import pytest

from repro import roofline as jroof
from repro_torch import roofline
import torch_threads  # noqa: F401,E402 — one intra-op thread a worker

H100 = roofline.CARDS[roofline.CARD]
FIELDS = ("flops", "hbm_bytes", "coll_bytes", "t_compute", "t_memory", "t_collective",
          "dominant", "model_flops_per_dev", "useful_ratio", "mfu_bound", "fits_hbm", "mem_gb",
          "extrapolated", "step")


def _rec(arch, shape, probe, flops, hbm, coll, mem, fp32=0.0, step="train_step"):
    return {"arch": arch, "shape": shape, "probe": probe, "n_devices": 1, "status": "ok",
            "meta": {"step": step},
            "memory": {"argument_size_in_bytes": mem[0], "temp_size_in_bytes": mem[1]},
            "cost": {"flops": flops + fp32, "flops_bf16": flops, "flops_fp32": fp32,
                     "bytes accessed": hbm},
            "collectives": {"all-reduce": {"count": 1, "bytes": coll}} if coll else {},
            "collective_bytes_total": coll, "model_flops": 6.0e15,
            "card": {"name": roofline.CARD, "memory_bytes": 16 * 2**30}}


def _write(d, mesh, recs):
    for (arch, shape, probe), rec in recs.items():
        suffix = f"__p{probe}" if probe else ""
        (d / f"{arch}__{shape}__{mesh}{suffix}.json").write_text(json.dumps(rec))


CELLS = {  # qwen3-1.7b: 28 one-layer periods; the decode cell has no probes
    ("qwen3-1.7b", "train_4k", 0): _rec("qwen3-1.7b", "train_4k", 0, 9e15, 4e14, 3e9,
                                        (12 * 2**30, 3 * 2**30)),
    ("qwen3-1.7b", "train_4k", 1): _rec("qwen3-1.7b", "train_4k", 1, 1e15, 2e13, 1e8, (1, 1)),
    ("qwen3-1.7b", "train_4k", 2): _rec("qwen3-1.7b", "train_4k", 2, 1.3e15, 3e13, 2e8, (1, 1)),
    ("qwen3-1.7b", "decode_32k", 0): _rec("qwen3-1.7b", "decode_32k", 0, 1e12, 2e11, 0,
                                          (10 * 2**30, 7 * 2**30), step="serve_step"),
    ("xlstm-1.3b", "prefill_32k", 0): _rec("xlstm-1.3b", "prefill_32k", 0, 1e13, 1e10, 0,
                                           (2**30, 2**30), step="prefill_step"),
}


def test_analyze_cell_is_the_references_when_every_flop_is_bf16(tmp_path, monkeypatch):
    monkeypatch.setattr(jroof, "PEAK_FLOPS", H100["bf16"])
    monkeypatch.setattr(jroof, "HBM_BW", H100["hbm"])
    monkeypatch.setattr(jroof, "ICI_BW", H100["link"])
    _write(tmp_path, "16x16", CELLS)
    _write(tmp_path, roofline.MESH, CELLS)
    ref = {(c.arch, c.shape): c for c in jroof.analyze_all(str(tmp_path), "16x16")}
    got = {(c.arch, c.shape): c for c in roofline.analyze_all(str(tmp_path))}
    assert sorted(got) == sorted(ref) == [("qwen3-1.7b", "decode_32k"),
                                          ("qwen3-1.7b", "train_4k"), ("xlstm-1.3b", "prefill_32k")]
    for key, r in ref.items():
        for f in FIELDS:
            want = getattr(r, f)
            assert getattr(got[key], f) == (pytest.approx(want, rel=1e-12)
                                            if isinstance(want, float) else want), (key, f)
    assert not got[("qwen3-1.7b", "decode_32k")].fits_hbm  # 17 GiB > 16
    assert got[("qwen3-1.7b", "train_4k")].extrapolated
    assert roofline.to_markdown(list(got.values())).count("\n") == 4
    cmp = roofline.compare_markdown(str(tmp_path), str(tmp_path))
    assert cmp.count("**1.0x**") == 3


def test_fp32_flops_take_the_cuda_cores(tmp_path):
    rec = _rec("xlstm-1.3b", "prefill_32k", 0, 1e13, 1e9, 0, (2**30, 2**30), fp32=2e12,
               step="prefill_step")
    rec["card"]["memory_bytes"] = H100["memory_bytes"]
    _write(tmp_path, roofline.MESH, {("xlstm-1.3b", "prefill_32k", 0): rec})
    (c,) = roofline.analyze_all(str(tmp_path))
    assert c.t_compute == pytest.approx(1e13 / 989e12 + 2e12 / 67e12, rel=1e-12)
    assert c.flops == 1.2e13 and c.dominant == "compute" and c.fits_hbm
    assert "CUDA cores" not in c.note  # fp32 is a sixth of the FLOPs but most of the time
    assert roofline.roofline_terms(0, 2e12, 0)["compute"] == pytest.approx(2e12 / 67e12)


def test_no_artifacts_give_an_empty_report(tmp_path, capsys):
    assert roofline.analyze_all(str(tmp_path)) == []
    roofline.main(["--out", str(tmp_path), "--markdown"])
    out = capsys.readouterr().out
    assert out.startswith("| arch | shape | step |") and out.strip().count("\n") == 1
    assert roofline.PEAKS[roofline.CARD] == (67e12, 989e12, 3.35e12)


def test_mesh_artifacts_are_read_per_device(tmp_path, monkeypatch):
    """The 16×16 artifacts (``--mesh single``), every count one device's: the
    port's report is the reference's, the collective term priced at
    NVLink's rate, MODEL_FLOPS spread over the 256 devices."""
    monkeypatch.setattr(jroof, "PEAK_FLOPS", H100["bf16"])
    monkeypatch.setattr(jroof, "HBM_BW", H100["hbm"])
    monkeypatch.setattr(jroof, "ICI_BW", H100["link"])
    cells = {k: {**v, "n_devices": 256} for k, v in CELLS.items()}
    _write(tmp_path, "16x16", cells)
    ref = {(c.arch, c.shape): c for c in jroof.analyze_all(str(tmp_path), "16x16")}
    for mesh in ("single", "16x16"):
        got = {(c.arch, c.shape): c for c in roofline.analyze_all(str(tmp_path), mesh)}
        assert sorted(got) == sorted(ref)
        for key, r in ref.items():
            for f in FIELDS:
                want = getattr(r, f)
                assert getattr(got[key], f) == (pytest.approx(want, rel=1e-12)
                                                if isinstance(want, float) else want), (key, f)
    train = got[("qwen3-1.7b", "train_4k")]
    assert train.mesh == "16x16" and train.t_collective > 0
    assert train.model_flops_per_dev == 6.0e15 / 256
    assert roofline.analyze_all(str(tmp_path), "multi") == []
