"""The port's embeddings frontend with M-RoPE (qwen2-vl-7b) and its
per-codebook heads (musicgen-medium) against the JAX reference on the CPU;
the registry's ten configs; batches in the reference's
``train_batch_struct`` layout through the train and select steps; and the
``convert`` round trips of the three families of this slice.

``apply_mrope`` holds fp32 positions and rotations to the reference's:
rtol 1e-6, atol 1e-6 (the same fp32 angles; sin and cos from another
library).  With three equal streams it is RoPE to the same tolerance (the
reference's ``tests/test_attention.py``).  Whole models, the reference's
consistency configs ``vlm`` and ``musicgen`` (``tests/test_models_
consistency.py``) and the two smoke configs, go through
``torch_lm_checks``, whose docstring states those tolerances; codebook
labels are (B, T, C).
"""
import dataclasses

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

import repro.models.model as jmodel
from repro.configs import registry as jregistry
from repro.models import layers as jlayers
from repro.models.config import ModelConfig as JModelConfig
from repro_torch import convert
from repro_torch.configs import ARCHS, get_config, smoke_config
from repro_torch.models import layers as tlayers
from repro_torch.models import model as tmodel
from repro_torch.models.config import ModelConfig, validate_config
from repro_torch.optim import adamw
from repro_torch.train.train_step import make_select_step, make_train_step
import torch_lm_checks as checks
from torch_lm_checks import ref_init  # noqa: E402
import torch_threads  # noqa: F401,E402 — one intra-op thread a worker

CONSISTENCY = {
    "vlm": dict(name="vlm", family="vlm", n_layers=2, d_model=64, n_heads=4, n_kv_heads=2,
                d_ff=128, vocab_size=128, mrope_sections=(4, 2, 2), frontend="embeddings"),
    "musicgen": dict(name="musicgen", family="audio", n_layers=2, d_model=64, n_heads=4,
                     n_kv_heads=4, d_ff=128, vocab_size=64, frontend="embeddings",
                     n_codebooks=4, activation="gelu", gated_ffn=False, norm="layernorm"),
}
SMOKE = {"vlm-smoke": "qwen2-vl-7b", "musicgen-smoke": "musicgen-medium"}
MODELS = sorted(CONSISTENCY) + sorted(SMOKE)


def _cfgs(name):
    if name in CONSISTENCY:
        return JModelConfig(**CONSISTENCY[name]), ModelConfig(**CONSISTENCY[name])
    return jregistry.smoke_config(SMOKE[name]), smoke_config(SMOKE[name])


@pytest.mark.parametrize("sections,theta", [((4, 2, 2), 1e4), ((2, 3, 3), 1e6)])
def test_mrope_matches_reference(sections, theta):
    rng = np.random.default_rng(0)
    x = rng.normal(size=(2, 9, 3, 16)).astype(np.float32)
    pos = rng.integers(0, 500, (2, 3, 9)).astype(np.int32)  # three different streams
    assert not (pos[:, 0] == pos[:, 1]).all()
    want = jlayers.apply_mrope(jnp.asarray(x), jnp.asarray(pos), sections, theta)
    got = tlayers.apply_mrope(torch.as_tensor(x), torch.as_tensor(pos), sections, theta)
    np.testing.assert_allclose(got.numpy(), np.asarray(want), rtol=1e-6, atol=1e-6)
    with pytest.raises(AssertionError):
        tlayers.apply_mrope(torch.as_tensor(x), torch.as_tensor(pos), (4, 2, 1), theta)


def test_mrope_with_equal_streams_is_rope():
    rng = np.random.default_rng(1)
    x = torch.as_tensor(rng.normal(size=(2, 7, 3, 16)).astype(np.float32))
    pos = torch.as_tensor(np.tile(np.arange(7, dtype=np.int32) * 3, (2, 1)))
    got = tlayers.apply_mrope(x, pos[:, None].expand(2, 3, 7), (4, 2, 2), 1e6)
    want = tlayers.apply_rope(x, pos, 1e6)
    np.testing.assert_allclose(got.numpy(), want.numpy(), rtol=1e-6, atol=1e-6)


def test_the_ten_configs_are_the_references():
    """Every registered config equals the reference's, builds in the port,
    and counts the reference's parameters; the tables the port allocates
    hold what ``stored_param_count`` derives from that count (padded
    vocabulary rows, and what the count leaves out), also with the
    embedding tied or untied."""
    assert sorted(ARCHS) == sorted(jregistry.ARCHS) and len(ARCHS) == 10
    for arch in ARCHS:
        ours, theirs = get_config(arch), jregistry.get_config(arch)
        assert dataclasses.asdict(ours) == dataclasses.asdict(theirs), arch
        assert ours.param_count() == theirs.param_count(), arch
        validate_config(ours)
        for cfg in (ours, dataclasses.replace(ours, tie_embeddings=not ours.tie_embeddings)):
            n = sum(int(np.prod(s)) for s in tmodel.param_shapes(cfg).values())
            assert n == tmodel.stored_param_count(cfg), (arch, cfg.tie_embeddings)
    assert get_config("qwen2-vl-7b").param_count() == 7_070_619_136  # 28.3 GB in fp32
    assert get_config("musicgen-medium").param_count() == 1_371_686_400  # 5.5 GB


@pytest.mark.parametrize("mode", ["fp32", "bf16"])
@pytest.mark.parametrize("name", MODELS)
def test_training_entry_points_match_reference(name, mode, monkeypatch):
    if mode == "fp32":
        monkeypatch.setattr(jmodel, "COMPUTE_DTYPE", jnp.float32)
        monkeypatch.setattr(tmodel, "COMPUTE_DTYPE", torch.float32)
    jcfg, cfg = _cfgs(name)
    jp, tp = checks.pair(jcfg, cfg)
    assert "embed" not in tp
    if cfg.n_codebooks > 1:
        assert tuple(tp["unembed"].shape) == (cfg.n_codebooks, cfg.padded_vocab, cfg.d_model)
    checks.check_training_entry_points(jcfg, cfg, jp, tp, checks.make_batch(cfg, 1), mode)


@pytest.mark.parametrize("name", MODELS)
def test_prefill_and_decode_match_reference(name):
    jcfg, cfg = _cfgs(name)
    jp, tp = checks.pair(jcfg, cfg, seed=1)
    checks.check_serving_entry_points(jcfg, cfg, jp, tp, checks.make_batch(cfg, 2))


@pytest.mark.parametrize("name", ["vlm", "musicgen"])
def test_train_and_select_steps_take_the_reference_batch_layout(name):
    """embeddings (B, T, D) bf16, positions (B, 3, T), labels (B, T, C):
    one AdamW step (two micro-batches) lowers the γ-weighted loss, and the
    select step's proxies are the model's."""
    _, cfg = _cfgs(name)
    params = tmodel.init_params(cfg, torch.Generator().manual_seed(0))
    batch = checks.tb(checks.make_batch(cfg, 4))
    batch["embeddings"] = batch["embeddings"].to(torch.bfloat16)
    before, _ = tmodel.loss_fn(params, cfg, batch)
    opt = adamw(lambda step: 1e-2)
    state = opt.init(params)
    step = make_train_step(cfg, opt, microbatches=2)
    for _ in range(3):
        params, state, m = step(params, state, batch)
    after, _ = tmodel.loss_fn(params, cfg, batch)
    assert np.isfinite(float(m["loss"])) and float(after) < float(before)
    feats = make_select_step(cfg)(params, batch)  # 'auto': the einsum path on the CPU
    assert tuple(feats.shape) == (checks.B, cfg.d_model)
    torch.testing.assert_close(feats, tmodel.proxy_features(params, cfg, batch), rtol=0, atol=0)
    twin = make_select_step(cfg, "torch")(params, batch)
    wmax = float(tmodel.unembed_matrix(params).abs().max())
    torch.testing.assert_close(twin, feats, rtol=0, atol=2.0**-5 * wmax)


@pytest.mark.parametrize("arch", ["xlstm-1.3b", "qwen2-vl-7b", "musicgen-medium"])
def test_convert_round_trip_and_refusal(arch):
    """A reference tree of each family of this slice carried across: the
    port's parameter names and shapes exactly (codebook heads transposed to
    (C, V, D), no ``embed`` for the embeddings frontend), values equal; a
    tree with a missing or an extra leaf, or another shape, is refused."""
    jcfg, cfg = jregistry.smoke_config(arch), smoke_config(arch)
    tree = jax.tree.map(np.asarray, ref_init(jcfg, 3))
    tp = convert.model_params_from_reference(tree, cfg, device="cpu")
    assert {k: tuple(v.shape) for k, v in tp.items()} == tmodel.param_shapes(cfg)
    un = np.swapaxes(tree["unembed"], -1, -2)
    np.testing.assert_array_equal(tp["unembed"].numpy(), un)
    if arch == "xlstm-1.3b":
        np.testing.assert_array_equal(
            tp["layers.7.mixer.r_in"].numpy(), tree["stack"]["scanned"][7]["mixer"]["r_in"][0])
    bad = {k: v for k, v in tree.items() if k != "unembed"}
    with pytest.raises(ValueError, match="missing"):
        convert.model_params_from_reference(bad, cfg, device="cpu")
    scanned = list(tree["stack"]["scanned"])
    n_full = scanned[0]["norm1"]["scale"].shape[0]
    scanned[0] = dict(scanned[0], extra=np.zeros((n_full, 2), np.float32))
    with pytest.raises(ValueError, match="extra"):
        convert.model_params_from_reference(
            dict(tree, stack=dict(tree["stack"], scanned=tuple(scanned))), cfg, device="cpu")
    with pytest.raises(ValueError, match="shapes"):
        convert.model_params_from_reference(dict(tree, unembed=tree["unembed"][..., :-1]),
                                            cfg, device="cpu")
