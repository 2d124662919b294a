"""The serving knobs of the port (counterpart of the serving plane of
`ray_tpu/core/config.py`).

Same names, defaults and environment variables as the JAX package: each
knob can be overridden with `RAY_TPU_<NAME>`, parsed to the declared type.
Only the knobs the paged serving engine reads are here.
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
    # Prompt-lookup speculative decoding: 0/1 disables (the port has no
    # speculative path yet; >= 2 raises in the engine).
    serve_speculation_k: int = 0

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
