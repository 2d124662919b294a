"""The knobs of the port (counterpart of `ray_tpu/core/config.py`).

Same names, defaults and environment variables as the JAX package: each
knob can be overridden with `RAY_TPU_<NAME>`, parsed to the declared type.
Only the knobs the port reads are here: the cluster address `init` joins,
and the serving engines'.
"""
from __future__ import annotations

import dataclasses
import os
from typing import Any


def _env_override(name: str, default: Any) -> Any:
    raw = os.environ.get(f"RAY_TPU_{name.upper()}")
    if raw is None:
        return default
    t = type(default)
    if t is bool:
        return raw.lower() in ("1", "true", "yes")
    if t is int:
        return int(raw)
    if t is float:
        return float(raw)
    return raw


@dataclasses.dataclass
class Config:
    # Cluster address `init()` joins when given none (RAY_TPU_ADDRESS,
    # exported to submitted jobs); "" starts a new cluster.
    address: str = ""
    # Tokens per KV block. Small blocks waste less memory on short tails
    # but deepen block tables; 16 matches the vLLM default.
    kv_block_size: int = 16
    # Blocks in the pool (block 0 is the reserved null block and never
    # allocated). 0 => derived from the engine's num_slots * max_len.
    kv_block_count: int = 0
    # Refcounted prefix-block sharing + copy-on-write. 0 disables: every
    # request prefills from scratch.
    kv_block_prefix_sharing: bool = True
    # Prompt tokens admitted per engine tick during prefill: long prompts
    # prefill in chunks interleaved with decode bursts.
    serve_prefill_chunk: int = 128
    # Per-request streaming token queue bound: a consumer that falls this
    # many tokens behind has its stream dropped with an explicit error.
    serve_stream_queue_max: int = 1024
    # Prompt-lookup speculative decoding on the paged engine: the default
    # draft window K for engines that don't pass speculation_k. 0/1
    # disables; >= 2 verifies K candidates (1 carried token + K-1 n-gram
    # proposals) per tick in one width-K call. Exact under greedy decoding.
    serve_speculation_k: int = 0
    # Trailing n-gram length the drafter matches against each slot's own
    # context (prompt + generated tokens) to find proposals.
    serve_speculation_ngram: int = 2

    def __post_init__(self):
        for f in dataclasses.fields(self):
            setattr(self, f.name, _env_override(f.name, getattr(self, f.name)))


_config: Config | None = None


def get_config() -> Config:
    global _config
    if _config is None:
        _config = Config()
    return _config


def reset_config() -> None:
    global _config
    _config = None
