"""AccaSim on PyTorch and CUDA: the workload-management simulator with its
batched dispatchers, and the falcon-mamba-7b serving path, running on
hand-written Hopper kernels.

Layout mirrors the JAX reference package file by file:

* ``core`` — the event-driven simulator (numpy on the host) and the
  dispatchers; ``core.dispatchers.vectorized`` runs FF/BF scoring and the
  EASY-backfilling shadow scan as CUDA kernels on an explicit device;
* ``configs``, ``models``, ``serving`` — the model configurations, the
  attention-free Mamba-1 LM (its prefill on the selective-scan kernel)
  and prefill / greedy decode / request batching;
* ``kernels`` — the CUDA sources, their build, wrappers and plain
  PyTorch versions;
* ``workloads``, ``telemetry``, ``utils`` — readers, the telemetry
  schema and process statistics.
"""
