"""Hugging Face checkpoint import for Llama-architecture models,
counterpart of `ray_tpu/models/hf_convert.py`.

Load a `transformers` Llama-family causal LM (Llama/Mistral/Qwen2-no-bias:
RMSNorm + half-rotation RoPE + SwiGLU + GQA, which is exactly this
package's transformer) and get back a `TransformerConfig` and the params
that `forward`, `make_train_step` and the serving engines take.

Weight mapping (HF stores Linear weights [out, in]; ours are [in, out],
per-layer tensors stacked on a leading L axis):

    model.embed_tokens.weight [V, d]      -> embed            (as-is)
    layers.i.self_attn.{q,k,v}_proj       -> wq/wk/wv         (transpose)
    layers.i.self_attn.o_proj             -> wo               (transpose)
    layers.i.mlp.{gate,up,down}_proj      -> w_gate/w_up/w_down (transpose)
    layers.i.input_layernorm              -> attn_norm
    layers.i.post_attention_layernorm     -> mlp_norm
    model.norm                            -> final_norm
    lm_head                               -> lm_head          (transpose)

No permutation is needed: both sides use the half-rotation ("rotate
half") RoPE layout. The tensors stay torch tensors: each is cast and
transposed on the target device and copied into its place in the stacked
parameter, so the import holds the checkpoint plus the params, with no
numpy round trip (numpy has no bf16). The module reads the HF config by
attribute and does not import `transformers`.
"""
from __future__ import annotations

from typing import Any, Dict, Optional, Tuple

import torch

from ray_tpu_torch.models.transformer import TransformerConfig, resolve_device


def config_from_hf(hf_config: Any, *, name: Optional[str] = None,
                   param_dtype: torch.dtype | None = None) -> TransformerConfig:
    """Map a transformers Llama-family config onto TransformerConfig."""
    get = lambda k, default=None: getattr(hf_config, k, default)  # noqa: E731
    required = ("vocab_size", "hidden_size", "num_hidden_layers",
                "num_attention_heads", "intermediate_size")
    missing = [k for k in required if get(k) is None]
    if missing:
        raise ValueError(
            f"not a Llama-family config ({type(hf_config).__name__}): "
            f"missing {missing}")
    n_heads = get("num_attention_heads")
    kwargs = dict(
        name=name or get("model_type", "hf-import"),
        vocab_size=get("vocab_size"),
        d_model=get("hidden_size"),
        n_layers=get("num_hidden_layers"),
        n_heads=n_heads,
        n_kv_heads=get("num_key_value_heads") or n_heads,
        d_ff=get("intermediate_size"),
        max_seq_len=get("max_position_embeddings", 2048),
        rope_theta=float(get("rope_theta", 10000.0)),
        norm_eps=float(get("rms_norm_eps", 1e-5)),
        tie_embeddings=bool(get("tie_word_embeddings", False)),
        param_dtype=param_dtype or torch.float32,
    )
    if get("hidden_act", "silu") not in ("silu", "swish"):
        raise ValueError(
            f"unsupported activation {get('hidden_act')!r}: this "
            f"transformer is SwiGLU (silu) only")
    if get("attention_bias", False) or get("mlp_bias", False):
        raise ValueError(
            "model uses attention/mlp biases; this architecture has "
            "none (bias-free Llama family only)")
    scaling = get("rope_scaling")
    if scaling and (scaling.get("rope_type") or
                    scaling.get("type", "default")) != "default":
        # Llama-3.1+ ship non-trivial rope_scaling; importing without
        # it would be silently wrong at every position.
        raise ValueError(
            f"rope_scaling={scaling!r} is not supported: plain RoPE "
            f"only — importing would produce silently wrong logits")
    explicit_hd = get("head_dim")
    if explicit_hd and explicit_hd != kwargs["d_model"] // n_heads:
        raise ValueError(
            f"explicit head_dim={explicit_hd} != hidden_size/num_heads"
            f"={kwargs['d_model'] // n_heads}: unsupported layout")
    window = get("sliding_window")
    # Qwen-family configs carry sliding_window with use_sliding_window
    # False (full attention in practice): only a window actually in use
    # makes the import diverge.
    if not get("use_sliding_window", True):
        window = None
    if window and window < kwargs["max_seq_len"]:
        raise ValueError(
            f"sliding_window={window} < max_position_embeddings: this "
            f"attention is full-causal, logits would diverge beyond "
            f"the window (import with max_seq_len <= window instead)")
    return TransformerConfig(**kwargs)


def params_from_hf(state_dict: Dict[str, torch.Tensor], cfg: TransformerConfig,
                   device: torch.device | str = "cuda") -> dict:
    """HF state dict -> the port's stacked params, in `cfg.param_dtype` on
    `device`."""
    device = resolve_device(device)
    dt = cfg.param_dtype
    consumed: set = set()

    def w(key: str, copy: bool = False) -> torch.Tensor:
        consumed.add(key)
        return state_dict[key].detach().to(device=device, dtype=dt, copy=copy)

    def stack(fmt: str, transpose: bool) -> torch.Tensor:
        first = w(fmt.format(0))
        first = first.T if transpose else first
        out = torch.empty((cfg.n_layers, *first.shape), dtype=dt, device=device)
        out[0] = first
        for i in range(1, cfg.n_layers):
            layer = w(fmt.format(i))
            out[i] = layer.T if transpose else layer
        return out

    p = "model.layers.{}."
    blocks = {
        "attn_norm": stack(p + "input_layernorm.weight", False),
        "wq": stack(p + "self_attn.q_proj.weight", True),
        "wk": stack(p + "self_attn.k_proj.weight", True),
        "wv": stack(p + "self_attn.v_proj.weight", True),
        "wo": stack(p + "self_attn.o_proj.weight", True),
        "mlp_norm": stack(p + "post_attention_layernorm.weight", False),
        "w_gate": stack(p + "mlp.gate_proj.weight", True),
        "w_up": stack(p + "mlp.up_proj.weight", True),
        "w_down": stack(p + "mlp.down_proj.weight", True),
    }
    params = {
        # Copies: the params must not alias the checkpoint's tensors,
        # which a train step would otherwise update in place.
        "embed": w("model.embed_tokens.weight", copy=True),
        "blocks": blocks,
        "final_norm": w("model.norm.weight", copy=True),
    }
    if not cfg.tie_embeddings:
        if "lm_head.weight" not in state_dict:
            raise ValueError(
                "config says tie_word_embeddings=False but the state "
                "dict has no lm_head.weight — mismatched checkpoint")
        params["lm_head"] = w("lm_head.weight").T.contiguous()
    else:
        # Tied models still list lm_head.weight (it aliases
        # embed_tokens): consumed by the tie, not dropped.
        consumed.add("lm_head.weight")
    # Refuse to DROP weights: biases (Qwen2), per-head q/k norms (Qwen3)
    # or any other unread parameter would silently change the model.
    # Rotary inv_freq buffers are derived, not parameters.
    leftover = [k for k in state_dict
                if k not in consumed
                and not k.endswith("rotary_emb.inv_freq")]
    if leftover:
        raise ValueError(
            f"state dict has tensors this architecture would drop: "
            f"{leftover[:4]}{'...' if len(leftover) > 4 else ''}")
    return params


def from_hf(model: Any, *, name: Optional[str] = None,
            param_dtype: torch.dtype | None = None,
            device: torch.device | str = "cuda") -> Tuple[TransformerConfig, dict]:
    """transformers model (or (config, state_dict) pair) ->
    (TransformerConfig, params) on `device`. Accepts
    `LlamaForCausalLM`-shaped models; pass `param_dtype=torch.bfloat16`
    to cast on import."""
    if isinstance(model, tuple):
        hf_cfg, sd = model
    else:
        hf_cfg, sd = model.config, model.state_dict()
    cfg = config_from_hf(hf_cfg, name=name, param_dtype=param_dtype)
    return cfg, params_from_hf(sd, cfg, device)
