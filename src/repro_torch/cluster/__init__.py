from .tpu_cluster import tpu_cluster_config, TPUJobFactory
from .job_profiles import JobProfile, profile_from_dryrun, load_profiles
from .failures import FailureInjector, FaultAwareScheduler
from .elastic import ElasticScaler, StragglerMonitor

__all__ = [
    "tpu_cluster_config", "TPUJobFactory",
    "JobProfile", "profile_from_dryrun", "load_profiles",
    "FailureInjector", "FaultAwareScheduler",
    "ElasticScaler", "StragglerMonitor",
]
