"""Runtime layers of the port (counterpart of `ray_tpu.core`): the config
knobs, ids, object refs, serialization, task specs, streaming and the
in-process engine (`local_engine.py`); `distributed/` holds the GPU
resource primitives so far."""
from ray_tpu_torch.core.config import Config, get_config, reset_config

__all__ = ["Config", "get_config", "reset_config"]
