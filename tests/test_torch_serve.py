"""The port's serving path (repro_torch.serve.serve_step, launch.serve's
decode mode, examples.serve_batched) on the CPU, and its greedy tokens
against the JAX reference's.

Greedy tokens are held to the reference's up to the first step, in each
row, where the reference's top-2 logit gap is under the bf16 tolerance
of ``test_torch_decode.py`` (2⁻⁵·max|logits|): past a near-tie the two
may rightly pick apart, and from there on they decode different
sequences.  (The port's logits sit ~1% of the largest one from the
reference's; exact top-2 ties occur in these random models.)
"""
import dataclasses

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

import repro.models.model as jmodel
from repro.configs import registry as jregistry
from repro.serve import serve_step as jserve
from repro_torch.configs import get_config, smoke_config
from repro_torch.examples import serve_batched
from repro_torch.launch import serve as launch_serve
from repro_torch.models import init_params, init_serve_state
from repro_torch.models.config import validate_config
from repro_torch.serve import greedy_generate, make_prefill_step, make_serve_step
from test_torch_decode import ARCHS, _model
import torch_threads  # noqa: F401,E402 — one intra-op thread a worker

CPU = torch.device("cpu")


def _prompts(cfg, B, T, seed=0):
    return torch.as_tensor(
        np.random.default_rng(seed).integers(0, cfg.vocab_size, (B, T)).astype(np.int32))


def test_greedy_generate_shapes_determinism_and_prefix():
    cfg = smoke_config("recurrentgemma-9b")
    params = init_params(cfg, torch.Generator().manual_seed(0))
    prompts = _prompts(cfg, 3, 5)
    out = greedy_generate(params, cfg, prompts, max_new=7)
    assert out.shape == (3, 12) and out.dtype == prompts.dtype
    assert torch.equal(out[:, :5], prompts)
    assert int(out.min()) >= 0 and int(out.max()) < cfg.padded_vocab
    assert torch.equal(out, greedy_generate(params, cfg, prompts, max_new=7))
    # a longer cache changes nothing: the masks hide the unwritten slots
    assert torch.equal(out, greedy_generate(params, cfg, prompts, max_new=7, max_len=20))


def test_serve_steps_are_prefill_and_decode():
    cfg = smoke_config("qwen3-1.7b")
    params = init_params(cfg, torch.Generator().manual_seed(1))
    toks = _prompts(cfg, 2, 6, 1)
    with torch.inference_mode():
        last = make_prefill_step(cfg)(params, {"tokens": toks})
        state = init_serve_state(cfg, 2, 6, CPU)
        step = make_serve_step(cfg)
        for t in range(6):
            logits, state = step(params, state, {"tokens": toks[:, t:t + 1]})
    assert last.shape == logits.shape == (2, cfg.padded_vocab) and state["pos"] == 6
    rel = float((last - logits).abs().max()) / float(last.abs().max())
    assert rel < 2e-2  # the forward-against-decode gate


@pytest.mark.parametrize("name", sorted(ARCHS))
def test_greedy_tokens_match_the_reference_up_to_a_near_tie(name):
    jcfg, cfg, jp, tp, step = _model(name)
    B, T, new = 8, 5, 7
    prompts = _prompts(cfg, B, T, 2)
    want = np.asarray(jserve.greedy_generate(jp, jcfg, jnp.asarray(prompts.numpy()), new))
    got = greedy_generate(tp, cfg, prompts, new).numpy()
    assert got.shape == want.shape == (B, T + new)
    # the reference's logits along its own tokens: where is each row's first near-tie?
    state = jmodel.init_serve_state(jcfg, B, T + new)
    gaps = []  # per generated step: is each row clear of a near-tie?
    for t in range(T + new - 1):
        logits, state = step(jp, state, {"tokens": jnp.asarray(want[:, t:t + 1])})
        if t >= T - 1:
            top2 = np.sort(np.asarray(logits), axis=-1)[:, -2:]
            tol = 2.0**-5 * np.abs(np.asarray(logits)).max(axis=-1)
            gaps.append(top2[:, 1] - top2[:, 0] > tol)
    clear = np.cumprod(np.stack(gaps, 1), axis=1).astype(bool)  # (B, new)
    assert clear.sum() >= 2, f"{name}: {clear.sum()} tokens clear of a near-tie"
    np.testing.assert_array_equal(np.where(clear, got[:, T:], -1), np.where(clear, want[:, T:], -1))


def test_launch_serve_decode_mode_on_the_cpu(capsys):
    out = launch_serve.main(["--arch", "qwen3-1.7b", "--smoke", "--device", "cpu",
                             "--batch", "2", "--prompt-len", "4", "--new", "5"])
    assert tuple(out.shape) == (2, 9)
    text = capsys.readouterr().out
    assert "qwen3-1.7b: (2, 9) in" in text and "on cpu" in text and "sample:" in text
    # seeded: the same tokens again
    again = launch_serve.main(["--arch", "qwen3-1.7b", "--smoke", "--device", "cpu",
                               "--batch", "2", "--prompt-len", "4", "--new", "5"])
    assert torch.equal(out, again)


def test_launch_serve_options_are_the_reference_launchers(capsys):
    out = launch_serve.main(["--arch", "xlstm-1.3b", "--smoke", "--device", "cpu",
                             "--batch", "2", "--prompt-len", "4", "--new", "3"])
    assert tuple(out.shape) == (2, 7) and "xlstm-1.3b: (2, 7) in" in capsys.readouterr().out
    with pytest.raises(SystemExit):
        launch_serve.main(["--arch", "mamba-2.8b", "--device", "cpu"])  # not registered
    with pytest.raises(SystemExit):
        launch_serve.main(["--device", "cpu"])  # --arch or --coreset
    with pytest.raises(ValueError, match="codebook heads"):
        launch_serve.main(["--arch", "musicgen-medium", "--smoke", "--device", "cpu"])


@pytest.mark.parametrize("window", [0, 8])
def test_serve_batched_example_on_the_cpu(window, capsys):
    out = serve_batched.main(["--device", "cpu", "--batch", "2", "--prompt-len", "6",
                              "--new", "6", "--window", str(window)])
    assert tuple(out.shape) == (2, 12)
    text = capsys.readouterr().out
    assert "deterministic: ✓" in text
    assert ("local window 8" if window else "global attention") in text
    cfg = serve_batched.demo_config(window)
    assert cfg.family == ("hybrid" if window else "dense")
    validate_config(cfg)


def test_recurrentgemma_config_is_the_reference():
    for ours, theirs in ((get_config("recurrentgemma-9b"), jregistry.get_config("recurrentgemma-9b")),
                         (smoke_config("recurrentgemma-9b"),
                          jregistry.smoke_config("recurrentgemma-9b"))):
        assert dataclasses.asdict(ours) == dataclasses.asdict(theirs)
        assert ours.param_count() == theirs.param_count()
        validate_config(ours)
    full = get_config("recurrentgemma-9b")
    assert full.param_count() == 10_444_558_336  # 41.8 GB in fp32
    assert full.layer_kinds[-3:] == ("local_attn", "rglru", "rglru")
    assert smoke_config("recurrentgemma-9b").layer_kinds == (
        "rglru", "rglru", "local_attn", "rglru", "rglru")


def test_serving_raises_for_cuda_without_a_card():
    if torch.cuda.is_available():
        pytest.skip("this machine has a card; the check is for CPU-only machines")
    cfg = smoke_config("qwen3-1.7b")
    with pytest.raises(RuntimeError, match="cuda"):
        launch_serve.main(["--arch", "qwen3-1.7b", "--smoke"])  # default --device cuda
    with pytest.raises(RuntimeError, match="cuda"):
        serve_batched.main([])  # default --device cuda
    with pytest.raises(RuntimeError, match="cuda"):
        init_serve_state(cfg, 1, 4)  # default device: the card
