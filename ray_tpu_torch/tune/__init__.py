"""ray_tpu_torch.tune: hyperparameter search (reference: ray.tune); the
port's copy of `ray_tpu.tune`.

Tuner + trial controller over the actor substrate, grid/random search,
ASHA / median-stopping / PBT schedulers, shared session+checkpoint
machinery with ray_tpu_torch.train. A trial's actor asks for no GPU: on a
card's node it sees the node's cards, so concurrent trials share them.
"""
from ray_tpu_torch.train.session import get_checkpoint, report
from ray_tpu_torch.tune.schedulers import (PB2, AsyncHyperBandScheduler,
                                           FIFOScheduler, HyperBandScheduler,
                                           MedianStoppingRule,
                                           PopulationBasedTraining)
from ray_tpu_torch.tune.search import (AskTellSearcher, BOHBSearcher,
                                       BasicVariantGenerator,
                                       ConcurrencyLimiter, Searcher,
                                       TPESearcher, choice, grid_search,
                                       loguniform, quniform, randint,
                                       sample_from, uniform)
from ray_tpu_torch.tune.callbacks import (Callback, CSVLoggerCallback,
                                          JsonLoggerCallback,
                                          MLflowLoggerCallback,
                                          WandbLoggerCallback)
from ray_tpu_torch.tune.tuner import ResultGrid, TuneConfig, Tuner

ASHAScheduler = AsyncHyperBandScheduler

__all__ = [
    "Tuner", "TuneConfig", "ResultGrid",
    "report", "get_checkpoint",
    "grid_search", "choice", "uniform", "loguniform", "randint",
    "quniform", "sample_from",
    "FIFOScheduler", "AsyncHyperBandScheduler", "ASHAScheduler",
    "HyperBandScheduler", "MedianStoppingRule", "PopulationBasedTraining",
    "Searcher", "BasicVariantGenerator", "TPESearcher", "BOHBSearcher",
    "AskTellSearcher", "PB2",
    "ConcurrencyLimiter",
    "Callback", "JsonLoggerCallback", "CSVLoggerCallback",
    "WandbLoggerCallback", "MLflowLoggerCallback",
]

# Usage tagging (ref: usage_lib.record_library_usage; local-only,
# see ray_tpu_torch/util/usage_stats.py)
from ray_tpu_torch.util.usage_stats import record_library_usage as _rlu

_rlu("tune")
del _rlu
