from .workload_generator import WorkloadGenerator

__all__ = ["WorkloadGenerator"]
