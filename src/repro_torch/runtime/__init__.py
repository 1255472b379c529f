"""Runtime policy of training: the step-time watchdog and the elastic
controller of distributed ZO."""

from repro_torch.runtime.elastic import ZOElasticController  # noqa: F401
from repro_torch.runtime.watchdog import StepStats, StragglerWatchdog  # noqa: F401
