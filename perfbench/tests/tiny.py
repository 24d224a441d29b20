"""A tiny benchmark cell made of new files only: a configuration, two
mixes, their limits and one extra metric reader in a temporary directory,
and a ``BENCHMARK.json`` there that adds them to the repository's own
entries.  Runs on the CPU in seconds."""
from __future__ import annotations

import json
from pathlib import Path

from perfbench.spec import HERE, Spec

TINY_CONFIG = {
    "source": "a test configuration", "model_family": "dense", "hidden_act": "silu",
    "hidden_size": 64, "intermediate_size": 96, "num_hidden_layers": 2,
    "num_attention_heads": 4, "num_key_value_heads": 2, "head_dim": 16, "vocab_size": 250,
    "qkv_bias": True, "tie_word_embeddings": False, "rope_theta": 10000.0,
    "rms_norm_eps": 1e-6, "compute_dtype": "bfloat16",
}
TINY_MIX = {"docs": 32, "seq_len": 16, "n_topics": 4, "batch": 4, "check_docs": 6,
            "reference_rows": 2}
# Set from CPU runs of these cells (seeds 3 to 6, 123456789012): sound runs
# read at most loss1 3.1e-4, grad1 4.8e-3, change3 1.3e-2, features 5.0e-3
# (the whole pool), the weighted step's loss 1.0e-3 and gradient 5.9e-3,
# select and gamma 0; the fp8 control at least loss1 6.3e-4, grad1 1.8e-2,
# features 3.0e-2, the weighted step's gradient 2.6e-2 (its loss 3.2e-4 and
# change3 7.7e-3 do not separate); the faults: unchanged change3 1.0;
# half_batch loss1 5.2e-3, change3 0.20; ignore_weights the weighted step's
# gradient 4.5e-2 (its loss 1.4e-4 at least); answer select 4.0e-3, gamma
# 6.3e-2.
TINY_LIMITS = {"loss1_gap": 1.5e-3, "grad1_gap": 1.2e-2, "change3_gap": 0.1, "feat0_gap": 1.2e-2,
               "featw_gap": 1.2e-2, "select_gap": 2e-3, "gamma_gap": 2e-2, "install_miss": 0,
               "wstep_loss_gap": 3e-3, "wstep_grad_gap": 1.2e-2}
EXTRA_METRIC = '''"""A metric added by a new file: steps completed in the window."""


def read(run):
    return float(len(run.steps))
'''


def make_tiny(tmp: Path) -> Spec:
    data = tmp / "perfbench"
    for sub in ("configs", "traffic", "limits", "metrics"):
        (data / sub).mkdir(parents=True)
    (data / "configs" / "tiny.json").write_text(json.dumps(TINY_CONFIG))
    for mix, base in (("tiny_refresh", "refresh_every_epoch"), ("tiny_full", "full_data")):
        m = json.loads((HERE / "traffic" / f"{base}.json").read_text())
        m.update(TINY_MIX)
        (data / "traffic" / f"{mix}.json").write_text(json.dumps(m))
    (data / "limits" / "tiny.refresh.json").write_text(json.dumps(TINY_LIMITS))
    (data / "limits" / "tiny.full.json").write_text(json.dumps(
        {k: TINY_LIMITS[k] for k in ("loss1_gap", "grad1_gap", "change3_gap")}))
    (data / "metrics" / "window_steps.py").write_text(EXTRA_METRIC)
    bench = json.loads((HERE.parent / "BENCHMARK.json").read_text())
    bench["configs"].append({"name": "tiny", "source": "a test configuration",
                             "file": "perfbench/configs/tiny.json", "reduced": [],
                             "why": "a CPU test"})
    bench["workloads"] += [
        {"name": "tiny.refresh", "config": "tiny", "traffic": "tiny_refresh", "chips": 1,
         "why": "a CPU test"},
        {"name": "tiny.full", "config": "tiny", "traffic": "tiny_full", "chips": 1,
         "why": "a CPU test"}]
    for m in bench["end_to_end"] + bench["per_layer"]:
        if "workloads" in m:
            m["workloads"].append("tiny.refresh")
    bench["per_layer"].append({"name": "window_steps", "unit": "steps", "better": "higher",
                               "source": "program_counter", "layer": "train step",
                               "moves": "train_tokens_per_s"})
    (tmp / "BENCHMARK.json").write_text(json.dumps(bench))
    return Spec(tmp / "BENCHMARK.json", search=(data, HERE))
