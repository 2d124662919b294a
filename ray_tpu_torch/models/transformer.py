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

Under a `mesh` the params are DTensors laid out by `param_logical_axes`
and a rule table (`parallel/sharding.py`), and each rank runs its rows
of the batch. Activations stay rank-local plain tensors: each block
gathers its weights over the data dims just before use (inside the
checkpoint, so backward gathers again), keeping their tensor-parallel
split: wq/wk/wv/w_gate/w_up by columns, wo and w_down by rows, each of
the latter followed by a psum over tp. The embedding and the head are
gathered whole.

Not ported yet (raises NotImplementedError naming its ROADMAP item):
sequence parallelism (`seq_shards > 1` or an sp axis, ring or ulysses),
expert parallelism, and MoE under a data or tensor split.
"""
from __future__ import annotations

import dataclasses
import functools
import math

import torch
import torch.nn.functional as F
from torch import nn
from torch.distributed.device_mesh import DeviceMesh
from torch.utils.checkpoint import (
    checkpoint, create_selective_checkpoint_contexts)

from ray_tpu_torch.ops.attention import flash_attention
from ray_tpu_torch.ops.moe import MOE_PARAMS, MoEConfig, moe_mlp
from ray_tpu_torch.ops.norms import rms_norm
from ray_tpu_torch.ops.rotary import apply_rope
from ray_tpu_torch.parallel.collectives import psum, pvary
from ray_tpu_torch.parallel.mesh import (
    AXIS_EXPERT, AXIS_SEQ, AXIS_TENSOR, mesh_axis_sizes)
from ray_tpu_torch.parallel.sharding import (
    DEFAULT_RULES, LogicalRules, gather_param, mesh_axes)


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


def param_logical_axes(cfg: TransformerConfig) -> dict:
    """Tree of logical-axis tuples matching `init_params` exactly."""
    blocks = {
        "attn_norm": ("layers", "embed"),
        "wq": ("layers", "embed", "heads"),
        "wk": ("layers", "embed", "kv_heads"),
        "wv": ("layers", "embed", "kv_heads"),
        "wo": ("layers", "heads", "embed"),
        "mlp_norm": ("layers", "embed"),
    }
    if cfg.n_experts > 0:
        blocks.update({
            "router": ("layers", "embed", "expert"),
            "w_gate": ("layers", "expert", "embed", "mlp"),
            "w_up": ("layers", "expert", "embed", "mlp"),
            "w_down": ("layers", "expert", "mlp", "embed"),
        })
    else:
        blocks.update({
            "w_gate": ("layers", "embed", "mlp"),
            "w_up": ("layers", "embed", "mlp"),
            "w_down": ("layers", "mlp", "embed"),
        })
    axes = {
        "embed": ("vocab", "embed"),
        "blocks": blocks,
        "final_norm": ("embed",),
    }
    if not cfg.tie_embeddings:
        axes["lm_head"] = ("embed", "vocab")
    return axes


@dataclasses.dataclass(frozen=True)
class Layout:
    """How forward meets a mesh: the mesh axes the batch rows split over
    (`batch`, of `batch_shards` ranks), and the axis that splits heads and
    the MLP (`tensor`, None when no rank holds a split). Without a mesh
    every method passes its input through."""
    mesh: DeviceMesh | None = None
    batch: tuple[str, ...] = ()
    batch_shards: int = 1
    tensor: str | None = None

    def weight(self, w, whole: bool = False):
        """The weight this rank computes with (see `gather_param`)."""
        keep = () if whole else (AXIS_TENSOR,)
        return gather_param(w, keep=keep, partial=self.batch)

    def enter(self, h):
        """A replicated activation on its way into column-split products."""
        return h if self.tensor is None else pvary(h, self.tensor, mesh=self.mesh)

    def leave(self, out):
        """The partial sums of a row-split product, summed over tp."""
        return out if self.tensor is None else psum(out, self.tensor, mesh=self.mesh)


def layout_for(cfg: TransformerConfig, mesh: DeviceMesh | None,
               rules: LogicalRules = DEFAULT_RULES) -> Layout:
    """The Layout of `cfg` under `mesh` and `rules`; raises for what this
    port does not run yet."""
    if mesh is None:
        return Layout()
    sizes = mesh_axis_sizes(mesh)
    if sizes.get(AXIS_SEQ, 1) > 1:
        raise NotImplementedError(
            f"a mesh with sp={sizes[AXIS_SEQ]} (sequence parallelism) is not "
            "ported yet: ROADMAP queue A, item 7")
    if sizes.get(AXIS_EXPERT, 1) > 1:
        raise NotImplementedError(
            f"a mesh with ep={sizes[AXIS_EXPERT]} (expert parallelism) is not "
            "ported yet: ROADMAP queue A, item 12")
    batch = tuple(a for a in mesh_axes(rules, "batch", mesh) if sizes[a] > 1)
    split = {n: tuple(a for a in mesh_axes(rules, n, mesh) if sizes[a] > 1)
             for n in ("heads", "kv_heads", "mlp")}
    if len(set(split.values())) > 1 or \
            set(split.values()) - {(), (AXIS_TENSOR,)}:
        raise ValueError(f"heads, kv_heads and mlp must all split over "
                         f"{AXIS_TENSOR!r} or none: {split}")
    tensor = AXIS_TENSOR if split["heads"] else None
    if tensor and (cfg.n_heads % sizes[tensor] or cfg.n_kv_heads % sizes[tensor]):
        raise ValueError(f"{cfg.n_heads} heads and {cfg.n_kv_heads} kv heads "
                         f"do not split over tp={sizes[tensor]}")
    if cfg.n_experts > 0 and (batch or tensor):
        raise NotImplementedError(
            "MoE under a data or tensor split is not ported yet (its routing "
            "must span the global batch): ROADMAP queue A, item 12")
    return Layout(mesh=mesh, batch=batch,
                  batch_shards=math.prod(sizes[a] for a in batch), tensor=tensor)


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


def _attn(x, bp: dict, positions, cfg: TransformerConfig, lay: Layout):
    """The block's attention half: x + wo(attention(norm(x))), over this
    rank's heads under a tensor split."""
    cd = cfg.compute_dtype
    b, t = x.shape[:2]
    h = lay.enter(rms_norm(x, lay.weight(bp["attn_norm"]), eps=cfg.norm_eps))
    q = (h @ lay.weight(bp["wq"]).to(cd)).view(b, t, -1, cfg.head_dim)
    k = (h @ lay.weight(bp["wk"]).to(cd)).view(b, t, -1, cfg.head_dim)
    v = (h @ lay.weight(bp["wv"]).to(cd)).view(b, t, -1, cfg.head_dim)
    q = apply_rope(q, positions, theta=cfg.rope_theta)
    k = apply_rope(k, positions, theta=cfg.rope_theta)
    attn = _attention(q, k, v, cfg).reshape(b, t, -1)
    return x + lay.leave(attn @ lay.weight(bp["wo"]).to(cd))


def _ff_hidden(x, bp: dict, cfg: TransformerConfig, lay: Layout):
    """The dense MLP's hidden, silu(h W_gate) * (h W_up), w_down's input
    (this rank's columns under a tensor split)."""
    cd = cfg.compute_dtype
    h = lay.enter(rms_norm(x, lay.weight(bp["mlp_norm"]), eps=cfg.norm_eps))
    return F.silu(h @ lay.weight(bp["w_gate"]).to(cd)) * \
        (h @ lay.weight(bp["w_up"]).to(cd))


def _ff_out(hidden, bp: dict, cfg: TransformerConfig, lay: Layout):
    return lay.leave(hidden @ lay.weight(bp["w_down"]).to(cfg.compute_dtype))


def _block(x, bp: dict, positions, cfg: TransformerConfig, lay: Layout):
    """One block: (x out, aux losses of its MoE layer or {})."""
    x = _attn(x, bp, positions, cfg, lay)
    if cfg.n_experts > 0:
        h = rms_norm(x, lay.weight(bp["mlp_norm"]), eps=cfg.norm_eps)
        out, aux = moe_mlp(h, {n: lay.weight(bp[n]) for n in MOE_PARAMS}, cfg.moe)
        return x + out, aux
    return x + _ff_out(_ff_hidden(x, bp, cfg, lay), bp, cfg, lay), {}


# "dots": keep the outputs of the products with no batch dims (each weight
# product folds to `aten.mm`), as dots_with_no_batch_dims_saveable does;
# recompute the rest, the experts' batched products (`aten.bmm`) and the
# attention kernels included.
_save_dots = functools.partial(create_selective_checkpoint_contexts,
                               [torch.ops.aten.mm.default,
                                torch.ops.aten.addmm.default])


def _block_saving_ff_hidden(x, bp: dict, positions, cfg: TransformerConfig,
                            lay: Layout):
    """Remat "ff": the block up to the FF hidden is recomputed in backward;
    w_down runs outside the checkpoint, so its product holds the hidden
    (and the bf16 w_down it was given) and nothing else of the block."""
    def to_hidden(x, bp):
        x = _attn(x, bp, positions, cfg, lay)
        return x, _ff_hidden(x, bp, cfg, lay)

    x, hidden = checkpoint(to_hidden, x, bp, use_reentrant=False)
    return x + _ff_out(hidden, bp, cfg, lay), {}


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
            rules: LogicalRules = DEFAULT_RULES, mesh: DeviceMesh | None = None,
            positions: torch.Tensor | None = None, seq_shards: int = 1,
            return_aux: dict | None = None):
    """tokens (B, T) int -> logits (B, T, vocab) in the compute dtype.

    Under a `mesh`, `params` are DTensors laid out by `rules` and `tokens`
    are this rank's rows; so are the logits. With MoE, `return_aux` (a
    dict) receives each auxiliary loss summed over the layers."""
    return _forward(params, tokens, cfg, layout_for(cfg, mesh, rules),
                    positions=positions, seq_shards=seq_shards,
                    return_aux=return_aux)


def _forward(params: dict, tokens: torch.Tensor, cfg: TransformerConfig,
             lay: Layout, *, positions=None, seq_shards: int = 1,
             return_aux: dict | None = None):
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
    embed = lay.weight(params["embed"], whole=True)
    x = embed.to(cd)[tokens]
    # unbind once: its backward stacks all layers' grads in one write.
    layers = {name: w.unbind(0) for name, w in params["blocks"].items()}
    auxes = []
    for i in range(cfg.n_layers):
        bp = {name: ws[i] for name, ws in layers.items()}
        x, aux = block(x, bp, positions, cfg, lay)
        auxes.append(aux)
    if return_aux is not None and cfg.n_experts > 0:
        return_aux.update({k: torch.stack([a[k] for a in auxes]).sum()
                           for k in auxes[0]})
    x = rms_norm(x, lay.weight(params["final_norm"]), eps=cfg.norm_eps)
    if cfg.tie_embeddings:
        return x @ embed.to(cd).t()
    return x @ lay.weight(params["lm_head"], whole=True).to(cd)


def loss_fn(params: dict, batch: dict, cfg: TransformerConfig, *,
            rules: LogicalRules = DEFAULT_RULES, mesh: DeviceMesh | None = None,
            seq_shards: int = 1):
    """Next-token cross entropy in fp32. batch: {"tokens": (B, T+1)} or
    {"tokens": (B, T), "targets": (B, T)}, optionally with a "mask".

    Under a `mesh` the batch is this rank's rows and the loss is the
    global batch's, the same on every rank: each rank's share of the
    global mean, summed over the data dims by a psum whose backward gives
    each rank its own share's grads (`gather_param` sums those)."""
    tokens = batch["tokens"]
    if "targets" in batch:
        inputs, targets = tokens, batch["targets"]
    else:
        inputs, targets = tokens[:, :-1], tokens[:, 1:]
    lay = layout_for(cfg, mesh, rules)
    # Logits in the compute dtype, then fp32 for the logsumexp.
    aux: dict = {}
    logits = _forward(params, inputs, cfg, lay, seq_shards=seq_shards,
                      return_aux=aux).float()
    logz = torch.logsumexp(logits, dim=-1)
    tgt = torch.gather(logits, -1, targets[..., None].long())[..., 0]
    nll = logz - tgt
    mask = batch.get("mask")
    if lay.mesh is not None:
        if mask is not None:
            count = psum(torch.sum(mask).detach(), lay.batch, mesh=lay.mesh)
            share = torch.sum(nll * mask) / torch.clamp(count, min=1.0)
        else:
            share = torch.sum(nll) / (nll.numel() * lay.batch_shards)
        loss = psum(share, lay.batch, mesh=lay.mesh)
    elif mask is not None:
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

