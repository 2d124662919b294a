"""Serving of the PyTorch/CUDA port (counterpart of `ray_tpu.serve`): the
fixed-slot and paged continuous-batching engines and the block allocator.
The serve control plane (controller, handles, proxy) is not ported yet."""
from ray_tpu_torch.serve.kv_cache import KVBlockAllocator, prefix_digest
from ray_tpu_torch.serve.llm import (
    LLMEngine, PagedLLMEngine, StreamQueueFullError)

__all__ = ["KVBlockAllocator", "LLMEngine", "PagedLLMEngine",
           "StreamQueueFullError", "prefix_digest"]
