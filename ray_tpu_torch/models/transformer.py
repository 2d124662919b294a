"""Decoder-only transformer (Llama-style), counterpart of
`ray_tpu/models/transformer.py`.

Parameters are a plain nested dict with the JAX package's tree: per-layer
tensors stacked on a leading layers axis, the same names and shapes, so
that `jax_bridge` is a plain copy. Master params are fp32 and are cast to
the compute dtype (bf16) at use. Attention is `flash_attention`, which runs
the hand-written CUDA kernels on the card. With remat, each block runs
under `torch.utils.checkpoint` (non-reentrant), so backward recomputes the
block's forward, attention kernel included, as `jax.checkpoint` does.

Not ported yet (each raises NotImplementedError naming its ROADMAP item):
remat policies "dots" and "ff", MoE (`n_experts > 0`) and sequence
parallelism (`seq_shards > 1`, ring or ulysses).
"""
from __future__ import annotations

import dataclasses

import torch
import torch.nn.functional as F
from torch import nn
from torch.utils.checkpoint import checkpoint

from ray_tpu_torch.ops.attention import flash_attention
from ray_tpu_torch.ops.norms import rms_norm
from ray_tpu_torch.ops.rotary import apply_rope


@dataclasses.dataclass(frozen=True)
class TransformerConfig:
    vocab_size: int = 32000
    d_model: int = 512
    n_layers: int = 4
    n_heads: int = 8
    n_kv_heads: int = 8
    d_ff: int = 1536
    max_seq_len: int = 2048
    rope_theta: float = 10000.0
    norm_eps: float = 1e-5
    tie_embeddings: bool = False
    param_dtype: torch.dtype = torch.float32
    compute_dtype: torch.dtype = torch.bfloat16
    remat: bool = True
    remat_policy: str = "full"
    sp_attention: str = "ring"
    n_experts: int = 0
    expert_top_k: int = 2
    capacity_factor: float = 1.25
    name: str = "transformer"

    @property
    def head_dim(self) -> int:
        return self.d_model // self.n_heads

    @property
    def num_params(self) -> int:
        d, f, v = self.d_model, self.d_ff, self.vocab_size
        kv = self.n_kv_heads * self.head_dim
        mlp = 3 * d * f if self.n_experts <= 0 else \
            self.n_experts * 3 * d * f + d * self.n_experts
        per_layer = d * d * 2 + d * kv * 2 + mlp + 2 * d
        emb = v * d * (1 if self.tie_embeddings else 2)
        return self.n_layers * per_layer + emb + d


def resolve_device(device: torch.device | str) -> torch.device:
    """The device an entry point runs on; CUDA without a GPU raises."""
    device = torch.device(device)
    if device.type == "cuda" and not torch.cuda.is_available():
        raise RuntimeError(
            "ray_tpu_torch runs on a CUDA device by default and none is "
            "available; pass device='cpu' to run the plain versions")
    return device


def _check_supported(cfg: TransformerConfig, seq_shards: int = 1) -> None:
    if cfg.n_experts > 0:
        raise NotImplementedError(
            "MoE (n_experts > 0) is not ported yet: ROADMAP queue A, item 6")
    if seq_shards > 1:
        raise NotImplementedError(
            f"seq_shards={seq_shards} ({cfg.sp_attention} attention) is not "
            "ported yet: ROADMAP queue A, item 7")
    if cfg.remat and cfg.remat_policy != "full":
        raise NotImplementedError(
            f"remat_policy={cfg.remat_policy!r} is not ported yet: ROADMAP "
            "queue A, item 4")


def param_shapes(cfg: TransformerConfig) -> dict:
    """Tree of parameter shapes, matching the JAX `init_params` exactly."""
    _check_supported(cfg)
    d, f, l, v = cfg.d_model, cfg.d_ff, cfg.n_layers, cfg.vocab_size
    q_width = cfg.n_heads * cfg.head_dim
    kv_width = cfg.n_kv_heads * cfg.head_dim
    shapes = {
        "embed": (v, d),
        "blocks": {
            "attn_norm": (l, d),
            "wq": (l, d, q_width),
            "wk": (l, d, kv_width),
            "wv": (l, d, kv_width),
            "wo": (l, q_width, d),
            "mlp_norm": (l, d),
            "w_gate": (l, d, f),
            "w_up": (l, d, f),
            "w_down": (l, f, d),
        },
        "final_norm": (d,),
    }
    if not cfg.tie_embeddings:
        shapes["lm_head"] = (d, v)
    return shapes


def init_params(cfg: TransformerConfig, generator: torch.Generator | None = None,
                *, device: torch.device | str = "cuda") -> dict:
    """Parameter tree drawn from `generator` (seed 0 on `device` if None).

    Same scales as the JAX init: N(0, 1/fan_in) weights, unit norms, and an
    embedding of std d**-0.75. The draws differ from jax.random's; tests
    carry JAX weights across with `jax_bridge` instead.
    """
    device = resolve_device(device)
    if generator is None:
        generator = torch.Generator(device=device).manual_seed(0)
    shapes = param_shapes(cfg)
    d = cfg.d_model
    fan_in = {"embed": d ** 0.5 * d, "wq": d, "wk": d, "wv": d,
              "wo": cfg.n_heads * cfg.head_dim, "w_gate": d, "w_up": d,
              "w_down": cfg.d_ff, "lm_head": d}

    def make(name, shape):
        if name.endswith("norm"):
            return torch.ones(shape, dtype=cfg.param_dtype, device=device)
        w = torch.randn(shape, generator=generator, dtype=torch.float32,
                        device=device)
        return (w * fan_in[name] ** -0.5).to(cfg.param_dtype)

    return {name: ({n: make(n, s) for n, s in shape.items()}
                   if isinstance(shape, dict) else make(name, shape))
            for name, shape in shapes.items()}


def _attention(q, k, v, cfg: TransformerConfig):
    """q (B,T,nh,hd), k/v (B,T,nkv,hd): GQA repeat, then flash attention.

    `repeat_interleave` matches `jnp.repeat`: each kv head is repeated in
    place (h0 h0 h1 h1 ...), not tiled.
    """
    if cfg.n_kv_heads != cfg.n_heads:
        rep = cfg.n_heads // cfg.n_kv_heads
        k = torch.repeat_interleave(k, rep, dim=2)
        v = torch.repeat_interleave(v, rep, dim=2)
    return flash_attention(q, k, v, True, None)


def _block(x, bp: dict, positions, cfg: TransformerConfig):
    cd = cfg.compute_dtype
    b, t = x.shape[:2]
    h = rms_norm(x, bp["attn_norm"], eps=cfg.norm_eps)
    q = (h @ bp["wq"].to(cd)).view(b, t, cfg.n_heads, cfg.head_dim)
    k = (h @ bp["wk"].to(cd)).view(b, t, cfg.n_kv_heads, cfg.head_dim)
    v = (h @ bp["wv"].to(cd)).view(b, t, cfg.n_kv_heads, cfg.head_dim)
    q = apply_rope(q, positions, theta=cfg.rope_theta)
    k = apply_rope(k, positions, theta=cfg.rope_theta)
    attn = _attention(q, k, v, cfg).reshape(b, t, cfg.n_heads * cfg.head_dim)
    x = x + attn @ bp["wo"].to(cd)

    h = rms_norm(x, bp["mlp_norm"], eps=cfg.norm_eps)
    hidden = F.silu(h @ bp["w_gate"].to(cd)) * (h @ bp["w_up"].to(cd))
    return x + hidden @ bp["w_down"].to(cd)


def forward(params: dict, tokens: torch.Tensor, cfg: TransformerConfig, *,
            positions: torch.Tensor | None = None, seq_shards: int = 1):
    """tokens (B, T) int -> logits (B, T, vocab) in the compute dtype."""
    _check_supported(cfg, seq_shards)
    cd = cfg.compute_dtype
    t = tokens.shape[1]
    if positions is None:
        positions = torch.arange(t, dtype=torch.int32, device=tokens.device)

    # Cast before the gather, as the JAX model does.
    x = params["embed"].to(cd)[tokens]
    # unbind once: its backward stacks all layers' grads in one write.
    layers = {name: w.unbind(0) for name, w in params["blocks"].items()}
    for i in range(cfg.n_layers):
        bp = {name: ws[i] for name, ws in layers.items()}
        if cfg.remat:
            x = checkpoint(_block, x, bp, positions, cfg, use_reentrant=False)
        else:
            x = _block(x, bp, positions, cfg)
    x = rms_norm(x, params["final_norm"], eps=cfg.norm_eps)
    if cfg.tie_embeddings:
        return x @ params["embed"].to(cd).t()
    return x @ params["lm_head"].to(cd)


def loss_fn(params: dict, batch: dict, cfg: TransformerConfig, *,
            seq_shards: int = 1):
    """Next-token cross entropy in fp32. batch: {"tokens": (B, T+1)} or
    {"tokens": (B, T), "targets": (B, T)}, optionally with a "mask"."""
    tokens = batch["tokens"]
    if "targets" in batch:
        inputs, targets = tokens, batch["targets"]
    else:
        inputs, targets = tokens[:, :-1], tokens[:, 1:]
    # Logits in the compute dtype, then fp32 for the logsumexp.
    logits = forward(params, inputs, cfg, seq_shards=seq_shards).float()
    logz = torch.logsumexp(logits, dim=-1)
    tgt = torch.gather(logits, -1, targets[..., None].long())[..., 0]
    nll = logz - tgt
    mask = batch.get("mask")
    if mask is not None:
        return torch.sum(nll * mask) / torch.clamp(torch.sum(mask), min=1.0)
    return torch.mean(nll)


class Transformer(nn.Module):
    """The parameter tree as an `nn.Module`, for callers that want one.

    `params()` returns the nested dict that `forward`/`loss_fn` take; the
    tensors are this module's parameters, so optimizers and `state_dict`
    see them.
    """

    def __init__(self, cfg: TransformerConfig, params: dict | None = None, *,
                 device: torch.device | str = "cuda"):
        super().__init__()
        self.cfg = cfg
        if params is None:
            params = init_params(cfg, device=device)
        self.blocks = nn.ParameterDict(
            {n: nn.Parameter(w) for n, w in params["blocks"].items()})
        self.top = nn.ParameterDict(
            {n: nn.Parameter(w) for n, w in params.items() if n != "blocks"})

    def params(self) -> dict:
        return {**self.top, "blocks": dict(self.blocks)}

    def forward(self, tokens: torch.Tensor) -> torch.Tensor:
        return forward(self.params(), tokens, self.cfg)

    def loss(self, batch: dict) -> torch.Tensor:
        return loss_fn(self.params(), batch, self.cfg)

