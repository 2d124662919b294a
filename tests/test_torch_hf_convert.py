"""ray_tpu_torch's HF Llama import against the JAX package's and against
transformers, on the CPU.

Built like tests/test_hf_convert.py: a randomly initialized local
`LlamaForCausalLM` (no download). The port's params must equal JAX
`from_hf`'s exactly; its fp32 logits must match transformers' within
1e-4, and the fixed-slot `LLMEngine` serving the imported weights must
give `generate`'s greedy tokens. Every rejection of the JAX import has a
case here.
"""
import dataclasses
import types

import numpy as np
import pytest
import torch

transformers = pytest.importorskip("transformers")

from ray_tpu.models.hf_convert import from_hf as jax_from_hf  # noqa: E402
from ray_tpu_torch.models import forward  # noqa: E402
from ray_tpu_torch.models.hf_convert import (  # noqa: E402
    config_from_hf, from_hf, params_from_hf)
from ray_tpu_torch.models.jax_bridge import params_to_numpy  # noqa: E402
from ray_tpu_torch.serve import LLMEngine  # noqa: E402

LOGITS_TOL = 1e-4


def _tiny_llama(tie=False, n_kv=2):
    cfg = transformers.LlamaConfig(
        vocab_size=128, hidden_size=64, intermediate_size=128,
        num_hidden_layers=2, num_attention_heads=4,
        num_key_value_heads=n_kv, max_position_embeddings=256,
        rms_norm_eps=1e-5, rope_theta=10000.0, tie_word_embeddings=tie,
        attention_bias=False, mlp_bias=False)
    torch.manual_seed(0)
    return transformers.LlamaForCausalLM(cfg).eval()


@pytest.mark.parametrize("tie,n_kv", [(False, 2), (True, 2), (False, 4)])
def test_params_equal_jax_import(tie, n_kv):
    model = _tiny_llama(tie=tie, n_kv=n_kv)
    jcfg, jparams = jax_from_hf(model, name="t")
    cfg, params = from_hf(model, name="t", device="cpu")
    for field in ("vocab_size", "d_model", "n_layers", "n_heads", "n_kv_heads",
                  "d_ff", "max_seq_len", "rope_theta", "norm_eps",
                  "tie_embeddings", "name"):
        assert getattr(cfg, field) == getattr(jcfg, field), field
    assert cfg.param_dtype == torch.float32
    want = {k: (({n: np.asarray(w) for n, w in v.items()}) if isinstance(v, dict)
                else np.asarray(v)) for k, v in jparams.items()}
    got = params_to_numpy(params)
    assert set(got) == set(want) and set(got["blocks"]) == set(want["blocks"])
    for name in ("embed", "final_norm") + (() if tie else ("lm_head",)):
        np.testing.assert_array_equal(got[name], want[name])
    for name, w in want["blocks"].items():
        np.testing.assert_array_equal(got["blocks"][name], w)


def test_params_do_not_alias_the_checkpoint():
    model = _tiny_llama()
    _, params = from_hf(model, device="cpu")
    sd = model.state_dict()
    for w in (params["embed"], params["final_norm"], params["lm_head"],
              *params["blocks"].values()):
        assert all(w.data_ptr() != t.data_ptr() for t in sd.values())


@pytest.mark.parametrize("tie", [False, True])
def test_logits_match_transformers(tie):
    model = _tiny_llama(tie=tie)
    cfg, params = from_hf(model, name="tiny-llama-test", device="cpu")
    cfg = dataclasses.replace(cfg, compute_dtype=torch.float32, remat=False)
    tokens = torch.from_numpy(np.random.default_rng(0).integers(
        0, cfg.vocab_size, (2, 16)))
    with torch.no_grad():
        ref = model(tokens).logits
        ours = forward(params, tokens, cfg)
    torch.testing.assert_close(ours, ref, atol=LOGITS_TOL, rtol=LOGITS_TOL)
    assert torch.equal(ours[:, -1].argmax(-1), ref[:, -1].argmax(-1))


def test_bf16_checkpoint_imports():
    """Real checkpoints ship bf16; the import casts in torch."""
    model = _tiny_llama().to(torch.bfloat16)
    cfg, params = from_hf(model, device="cpu")
    assert params["embed"].dtype == torch.float32
    out = forward(params, torch.tensor([[1, 2, 3]]),
                  dataclasses.replace(cfg, remat=False))
    assert torch.isfinite(out.float()).all()
    cfg16, p16 = from_hf(model, param_dtype=torch.bfloat16, device="cpu")
    assert cfg16.param_dtype == torch.bfloat16
    assert p16["blocks"]["wq"].dtype == torch.bfloat16
    torch.testing.assert_close(p16["blocks"]["wq"][1],
                               model.model.layers[1].self_attn.q_proj.weight.T,
                               atol=0, rtol=0)


def test_config_and_state_dict_pair():
    model = _tiny_llama()
    cfg_a, pa = from_hf(model, device="cpu")
    cfg_b, pb = from_hf((model.config, model.state_dict()), device="cpu")
    assert cfg_a == cfg_b
    np.testing.assert_array_equal(pa["blocks"]["w_down"], pb["blocks"]["w_down"])


def test_serve_engine_matches_transformers_generate():
    model = _tiny_llama()
    cfg, params = from_hf(model, device="cpu")
    cfg = dataclasses.replace(cfg, compute_dtype=torch.float32, remat=False)
    eng = LLMEngine(cfg, params, num_slots=2, max_len=64,
                    prefill_buckets=(16,), prefix_cache_size=0, device="cpu")
    try:
        for prompt in ([3, 17, 42, 7], [5, 9, 120, 64, 1, 77]):
            ours = eng.generate(prompt, max_tokens=6, temperature=0.0,
                                timeout=120)
            with torch.no_grad():
                ref = model.generate(torch.tensor([prompt]), max_new_tokens=6,
                                     do_sample=False)[0, len(prompt):].tolist()
            assert ours == ref, (ours, ref)
    finally:
        eng.shutdown()


def _llama_cfg(**kw):
    return transformers.LlamaConfig(**kw)


@pytest.mark.parametrize("hf_cfg,match", [
    (types.SimpleNamespace(vocab_size=10, hidden_size=8), "missing"),
    (_llama_cfg(hidden_act="gelu"), "SwiGLU"),
    (_llama_cfg(attention_bias=True), "bias"),
    (_llama_cfg(mlp_bias=True), "bias"),
    (_llama_cfg(rope_scaling={"rope_type": "llama3", "factor": 8.0,
                              "original_max_position_embeddings": 8192,
                              "low_freq_factor": 1.0, "high_freq_factor": 4.0}),
     "rope_scaling"),
    (_llama_cfg(rope_scaling={"type": "linear", "factor": 2.0}), "rope_scaling"),
    (_llama_cfg(hidden_size=64, num_attention_heads=4, head_dim=32), "head_dim"),
    (transformers.MistralConfig(sliding_window=128, max_position_embeddings=4096),
     "sliding_window"),
])
def test_config_rejections(hf_cfg, match):
    from ray_tpu.models.hf_convert import config_from_hf as jax_config_from_hf

    with pytest.raises(ValueError, match=match):
        jax_config_from_hf(hf_cfg)
    with pytest.raises(ValueError, match=match):
        config_from_hf(hf_cfg)


def test_config_accepts_what_jax_accepts():
    """An unused Qwen-style window, a default rope_scaling and a consistent
    head_dim import as in JAX."""
    for hf_cfg in (
            transformers.Qwen2Config(sliding_window=128, use_sliding_window=False,
                                     max_position_embeddings=4096),
            _llama_cfg(rope_scaling={"rope_type": "default"}),
            _llama_cfg(hidden_size=64, num_attention_heads=4, head_dim=16)):
        cfg = config_from_hf(hf_cfg)
        assert cfg.d_model == hf_cfg.hidden_size


def test_rejects_dropped_tensors():
    # Qwen2's q/k/v biases are refused, not dropped.
    qcfg = transformers.Qwen2Config(
        vocab_size=64, hidden_size=32, intermediate_size=64,
        num_hidden_layers=1, num_attention_heads=2, num_key_value_heads=2)
    with pytest.raises(ValueError, match="bias"):
        from_hf(transformers.Qwen2ForCausalLM(qcfg), device="cpu")
    # Any other unread tensor too.
    model = _tiny_llama()
    sd = dict(model.state_dict())
    sd["model.layers.0.self_attn.q_norm.weight"] = torch.ones(16)
    with pytest.raises(ValueError, match="drop"):
        from_hf((model.config, sd), device="cpu")


def test_rejects_untied_config_without_lm_head():
    model = _tiny_llama()
    sd = {k: v for k, v in model.state_dict().items() if k != "lm_head.weight"}
    cfg = config_from_hf(model.config)
    with pytest.raises(ValueError, match="lm_head"):
        params_from_hf(sd, cfg, device="cpu")


def test_import_defaults_to_the_card():
    if torch.cuda.is_available():
        pytest.skip("a CUDA device is present")
    with pytest.raises(RuntimeError, match="CUDA"):
        from_hf(_tiny_llama())
