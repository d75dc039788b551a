"""Tune: search spaces, the trial runner and the bridge callbacks.

Port of the JAX package's ``tune`` package: ``from
ray_lightning_accelerators_tpu_torch import tune; tune.run(...)``, or the
callbacks imported directly.
"""

from .callbacks import TuneReportCallback, TuneReportCheckpointCallback
from .run import (ExperimentAnalysis, Trial, autotune_step,
                  checkpoint_payload, default_step_space,
                  is_session_enabled, report, run, trial_devices,
                  trial_should_stop)
from .schedulers import (ASHAScheduler, FIFOScheduler, MedianStoppingRule,
                         TrialScheduler)
from .search import (TPESearcher, choice, grid_search, loguniform, randint,
                     uniform)

__all__ = [
    "run", "autotune_step", "default_step_space",
    "report", "checkpoint_payload", "is_session_enabled",
    "trial_should_stop", "trial_devices",
    "ExperimentAnalysis", "Trial",
    "choice", "uniform", "loguniform", "randint", "grid_search",
    "TPESearcher",
    "TuneReportCallback", "TuneReportCheckpointCallback",
    "TrialScheduler", "FIFOScheduler", "ASHAScheduler", "MedianStoppingRule",
]
