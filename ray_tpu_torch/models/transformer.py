"""Decoder-only transformer (Llama-style), counterpart of
`ray_tpu/models/transformer.py`.

Parameters are a plain nested dict with the JAX package's tree: per-layer
tensors stacked on a leading layers axis, the same names and shapes, so
that `jax_bridge` is a plain copy. Master params are fp32 and are cast to
the compute dtype (bf16) at use. Attention is `flash_attention`, which runs
the hand-written CUDA kernels on the card. With remat, each block runs
under `torch.utils.checkpoint` (non-reentrant), so backward recomputes the
block's forward, attention kernel included, as `jax.checkpoint` does. The
remat policies save what JAX's save: "full" nothing, "dots" the outputs of
the weight products without batch dims (`aten.mm`), "ff" only the dense
FF hidden. With `n_experts > 0` the MLP is Mixtral-style MoE
(`ops/moe.py`), whose auxiliary losses `loss_fn` adds.

Not ported yet (raises NotImplementedError naming its ROADMAP item):
sequence parallelism (`seq_shards > 1`, ring or ulysses).
"""
from __future__ import annotations

import dataclasses
import functools

import torch
import torch.nn.functional as F
from torch import nn
from torch.utils.checkpoint import (
    checkpoint, create_selective_checkpoint_contexts)

from ray_tpu_torch.ops.attention import flash_attention
from ray_tpu_torch.ops.moe import MOE_PARAMS, MoEConfig, moe_mlp
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
    # "full" recomputes the whole block in backward; "dots" saves the
    # weight products' outputs; "ff" saves only the dense FF hidden.
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
    def moe(self) -> MoEConfig | None:
        if self.n_experts <= 0:
            return None
        return MoEConfig(num_experts=self.n_experts, top_k=self.expert_top_k,
                         capacity_factor=self.capacity_factor)

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


def param_shapes(cfg: TransformerConfig) -> dict:
    """Tree of parameter shapes, matching the JAX `init_params` exactly."""
    d, f, l, v = cfg.d_model, cfg.d_ff, cfg.n_layers, cfg.vocab_size
    e = cfg.n_experts
    q_width = cfg.n_heads * cfg.head_dim
    kv_width = cfg.n_kv_heads * cfg.head_dim
    blocks = {
        "attn_norm": (l, d),
        "wq": (l, d, q_width),
        "wk": (l, d, kv_width),
        "wv": (l, d, kv_width),
        "wo": (l, q_width, d),
        "mlp_norm": (l, d),
    }
    if e > 0:
        blocks.update({"router": (l, d, e), "w_gate": (l, e, d, f),
                       "w_up": (l, e, d, f), "w_down": (l, e, f, d)})
    else:
        blocks.update({"w_gate": (l, d, f), "w_up": (l, d, f),
                       "w_down": (l, f, d)})
    shapes = {"embed": (v, d), "blocks": blocks, "final_norm": (d,)}
    if not cfg.tie_embeddings:
        shapes["lm_head"] = (d, v)
    return shapes


def init_params(cfg: TransformerConfig, generator: torch.Generator | None = None,
                *, device: torch.device | str = "cuda") -> dict:
    """Parameter tree drawn from `generator` (seed 0 on `device` if None).

    Same scales as the JAX init: N(0, 1/fan_in) weights, unit norms, and an
    embedding of std d**-0.75. The draws differ from jax.random's; tests
    carry JAX weights across with `jax_bridge` instead. A stacked block
    weight is drawn in fp32 one layer at a time into its `param_dtype`
    tensor, so the init holds one layer's fp32 draw beyond the weights
    (at mixtral-8x7b width a layer's w_gate is 1.9 GB in fp32; the whole
    stack over 32 layers would be 60 GB).
    """
    device = resolve_device(device)
    if generator is None:
        generator = torch.Generator(device=device).manual_seed(0)
    shapes = param_shapes(cfg)
    d = cfg.d_model
    fan_in = {"embed": d ** 0.5 * d, "wq": d, "wk": d, "wv": d,
              "wo": cfg.n_heads * cfg.head_dim, "router": d, "w_gate": d,
              "w_up": d, "w_down": cfg.d_ff, "lm_head": d}

    def draw(name, shape):
        w = torch.randn(shape, generator=generator, dtype=torch.float32,
                        device=device)
        return (w * fan_in[name] ** -0.5).to(cfg.param_dtype)

    def make(name, shape, stacked=False):
        if name.endswith("norm"):
            return torch.ones(shape, dtype=cfg.param_dtype, device=device)
        if not stacked:
            return draw(name, shape)
        w = torch.empty(shape, dtype=cfg.param_dtype, device=device)
        for layer in w:
            layer.copy_(draw(name, shape[1:]))
        return w

    return {name: ({n: make(n, s, stacked=True) for n, s in shape.items()}
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


def _attn(x, bp: dict, positions, cfg: TransformerConfig):
    """The block's attention half: x + wo(attention(norm(x)))."""
    cd = cfg.compute_dtype
    b, t = x.shape[:2]
    h = rms_norm(x, bp["attn_norm"], eps=cfg.norm_eps)
    q = (h @ bp["wq"].to(cd)).view(b, t, cfg.n_heads, cfg.head_dim)
    k = (h @ bp["wk"].to(cd)).view(b, t, cfg.n_kv_heads, cfg.head_dim)
    v = (h @ bp["wv"].to(cd)).view(b, t, cfg.n_kv_heads, cfg.head_dim)
    q = apply_rope(q, positions, theta=cfg.rope_theta)
    k = apply_rope(k, positions, theta=cfg.rope_theta)
    attn = _attention(q, k, v, cfg).reshape(b, t, cfg.n_heads * cfg.head_dim)
    return x + attn @ bp["wo"].to(cd)


def _ff_hidden(x, bp: dict, cfg: TransformerConfig):
    """The dense MLP's hidden, silu(h W_gate) * (h W_up), w_down's input."""
    cd = cfg.compute_dtype
    h = rms_norm(x, bp["mlp_norm"], eps=cfg.norm_eps)
    return F.silu(h @ bp["w_gate"].to(cd)) * (h @ bp["w_up"].to(cd))


def _block(x, bp: dict, positions, cfg: TransformerConfig):
    """One block: (x out, aux losses of its MoE layer or {})."""
    x = _attn(x, bp, positions, cfg)
    if cfg.n_experts > 0:
        h = rms_norm(x, bp["mlp_norm"], eps=cfg.norm_eps)
        out, aux = moe_mlp(h, {n: bp[n] for n in MOE_PARAMS}, cfg.moe)
        return x + out, aux
    return x + _ff_hidden(x, bp, cfg) @ bp["w_down"].to(cfg.compute_dtype), {}


# "dots": keep the outputs of the products with no batch dims (each weight
# product folds to `aten.mm`), as dots_with_no_batch_dims_saveable does;
# recompute the rest, the experts' batched products (`aten.bmm`) and the
# attention kernels included.
_save_dots = functools.partial(create_selective_checkpoint_contexts,
                               [torch.ops.aten.mm.default,
                                torch.ops.aten.addmm.default])


def _block_saving_ff_hidden(x, bp: dict, positions, cfg: TransformerConfig):
    """Remat "ff": the block up to the FF hidden is recomputed in backward;
    w_down runs outside the checkpoint, so its product holds the hidden
    (and the bf16 w_down it was given) and nothing else of the block."""
    def to_hidden(x, bp):
        x = _attn(x, bp, positions, cfg)
        return x, _ff_hidden(x, bp, cfg)

    x, hidden = checkpoint(to_hidden, x, bp, use_reentrant=False)
    return x + hidden @ bp["w_down"].to(cfg.compute_dtype), {}


def _block_fn(cfg: TransformerConfig):
    """`_block` under the config's remat policy. As in the JAX model, any
    policy but "dots" and "ff" is full remat."""
    if not cfg.remat:
        return _block
    if cfg.remat_policy == "dots":
        return functools.partial(checkpoint, _block, use_reentrant=False,
                                 context_fn=_save_dots)
    if cfg.remat_policy == "ff":
        if cfg.n_experts > 0:
            raise ValueError(
                "remat_policy='ff' names only the dense-MLP "
                "activation; with n_experts > 0 nothing would be "
                "saved (silent full remat) — use 'dots' or 'full'")
        return _block_saving_ff_hidden
    return functools.partial(checkpoint, _block, use_reentrant=False)


def forward(params: dict, tokens: torch.Tensor, cfg: TransformerConfig, *,
            positions: torch.Tensor | None = None, seq_shards: int = 1,
            return_aux: dict | None = None):
    """tokens (B, T) int -> logits (B, T, vocab) in the compute dtype.

    With MoE, `return_aux` (a dict) receives each auxiliary loss summed
    over the layers."""
    if seq_shards > 1:
        raise NotImplementedError(
            f"seq_shards={seq_shards} ({cfg.sp_attention} attention) is not "
            "ported yet: ROADMAP queue A, item 7")
    cd = cfg.compute_dtype
    t = tokens.shape[1]
    if positions is None:
        positions = torch.arange(t, dtype=torch.int32, device=tokens.device)
    block = _block_fn(cfg)

    # Cast before the gather, as the JAX model does.
    x = params["embed"].to(cd)[tokens]
    # unbind once: its backward stacks all layers' grads in one write.
    layers = {name: w.unbind(0) for name, w in params["blocks"].items()}
    auxes = []
    for i in range(cfg.n_layers):
        bp = {name: ws[i] for name, ws in layers.items()}
        x, aux = block(x, bp, positions, cfg)
        auxes.append(aux)
    if return_aux is not None and cfg.n_experts > 0:
        return_aux.update({k: torch.stack([a[k] for a in auxes]).sum()
                           for k in auxes[0]})
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
    aux: dict = {}
    logits = forward(params, inputs, cfg, seq_shards=seq_shards,
                     return_aux=aux).float()
    logz = torch.logsumexp(logits, dim=-1)
    tgt = torch.gather(logits, -1, targets[..., None].long())[..., 0]
    nll = logz - tgt
    mask = batch.get("mask")
    if mask is not None:
        loss = torch.sum(nll * mask) / torch.clamp(torch.sum(mask), min=1.0)
    else:
        loss = torch.mean(nll)
    if aux:  # MoE: load balance and router z-loss
        loss = loss + 0.01 * aux["moe_load_balance_loss"] + aux["moe_z_loss"]
    return loss


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

