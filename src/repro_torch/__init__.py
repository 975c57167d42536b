"""AccaSim on PyTorch and CUDA: the workload-management simulator with its
batched dispatchers running on hand-written Hopper kernels.

Layout mirrors the JAX reference package file by file:

* ``core`` — the event-driven simulator (numpy on the host) and the
  dispatchers; ``core.dispatchers.vectorized`` runs FF/BF scoring and the
  EASY-backfilling shadow scan as CUDA kernels on an explicit device;
* ``kernels`` — the CUDA sources, their build, wrappers and plain
  PyTorch versions;
* ``workloads``, ``telemetry``, ``utils`` — readers, the telemetry
  schema and process statistics.
"""
