"""Runtime layers of the port (counterpart of `ray_tpu.core`); only the
config knobs the serving engine reads are ported so far."""
from ray_tpu_torch.core.config import Config, get_config, reset_config

__all__ = ["Config", "get_config", "reset_config"]
