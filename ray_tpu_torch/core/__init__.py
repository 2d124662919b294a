"""Runtime layers of the port (counterpart of `ray_tpu.core`): the config
knobs, ids, object refs, serialization, task specs, streaming and the
in-process engine (`local_engine.py`), the client of the shared-memory
object store (`object_store.py`, over `csrc/object_store.cc`, which
`store_build.py` compiles); `distributed/` holds the single-host
multi-process runtime."""
from ray_tpu_torch.core.config import Config, get_config, reset_config

__all__ = ["Config", "get_config", "reset_config"]
