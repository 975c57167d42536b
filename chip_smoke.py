#!/usr/bin/env python3
"""Chip smoke test of the PyTorch/CUDA port of AccaSim, on one GPU.

Run from the root of a checkout, with no arguments::

    python3 chip_smoke.py

It builds the port's CUDA kernels from ``src/repro_torch/kernels/csrc``
and drives the simulator's main path on the card:

1. card: name and power limit, torch and CUDA versions, kernel build
   (ptxas registers and spills; the scan's registers, shared memory and
   resident warps per SM); the fleet engine's two libraries build in a
   thread while phases 2-7 run, and phase 8 waits for them;
2. Seth (the paper's Fig. 7 system, 120 nodes x 4 cores x 1 GB) with a
   Seth-like stream of 4,000 jobs: the 8 vectorized Table-2 rows and
   the per-job FIFO-vFF row on CUDA, each against its numpy twin;
3. a RICC-sized system (1024 nodes x 8 cores x 12 GB) with 5,000 jobs
   submitted within the first hour, so the queue is thousands of jobs
   deep: vEBF-vBF, FIFO-vBF and per-job FIFO-vFF against their numpy
   twins, capped by ``max_events``;
4. kernels: the copies per ``ops`` call (memcpy records per direction,
   from the profiler) and their bytes at the RICC peak; each dispatch
   kernel against its plain PyTorch version on the card, on the largest
   inputs each phase (Seth, RICC) gave it, in the kernel's own layout
   (fit bits and one score row; releases grouped by node), plus ragged,
   -1-floored and sparse edge cases, and R 9, 12 and 16 past the 8 types
   the kernels unroll (bits and counts exact, score bitwise); per phase
   its launches, time, device time over 200 calls, the plain version's
   time and its bound;
5. mamba: falcon-mamba-7b at full width (64 layers, d_model 4096, bf16,
   random weights from a seeded generator on the card) serves 8 requests
   through ``RequestBatcher`` (4 slots) and ``greedy_generate``: 4
   prompts of 512 tokens, then 4 of 1000, 32 new tokens each, each
   ``greedy_generate`` call timed whole.  Exactly 64 ``selective_scan``
   CUDA launches per prefill, and peak memory; then, outside the counted
   run, the same batches with each model call timed between two
   synchronises give prefill tokens/s, and decode tokens/s as the whole
   call less its prefill; one profiled prefill and 8 decode steps split
   device time into the scan, matrix products and the rest;
5b. smollm-360m at full width and depth (32 layers, d_model 960, 15/5
   heads, bf16, random weights) serves 8 requests through
   ``launch/serve.py``'s loop (4 slots; prompts of 512 and 1024 tokens,
   32 new tokens each, ``max_seq`` 1056): each prompt prefilled alone
   into its slot, decode steps of all slots; prefill and decode
   tokens/s and peak memory.  Each request's tokens equal greedy
   generation of its prompt alone at the loop's batch of 4 rows, and
   for one request of each prompt length whether ``greedy_generate`` at
   batch 1 gives the same is logged (bf16 products at 1 and 4 rows round
   apart);
6. the ``selective_scan`` kernel against its plain version on the
   largest inputs the serve run gave it (bf16) plus ragged S, Di and L in
   float32, bf16 and fp16, within 1e-4, with its times and bound; and
   the narrow inputs read natively bitwise equal to the same values
   upcast to float32;
7. serving consistency: falcon-mamba-7b and smollm-360m at full width
   cut to 4 layers in float32 (TF32 off): a 64-token prefill and 8
   decode steps match the train-mode forward's logits within 5e-4, and
   smollm's int8 KV cache within the reference's 0.15 relative error;
   then the qwen3-moe, llama4-maverick and Jamba smoke configs in
   float32 with ``capacity_factor`` 16 (no drops), within 5e-4; then
   internvl2-76b at full width cut to 2 layers (the prompt after its 256
   patches) and whisper-medium cut to 2 + 2 layers (256 frames), within
   5e-4;
5c. qwen3-moe-30b-a3b at full size (48 layers, 128 experts top-8,
   bf16, ~61 GB of random weights drawn leaf by leaf after the earlier
   phases' memory is freed) serves phase 5b's traffic through
   ``launch/serve.py``'s loop (8 requests of 512 and 1024 tokens, 4
   slots, 32 new tokens, ``max_seq`` 1056); each request equals
   generation of its prompt alone at the loop's batch, and the decode
   steps drop no slot (capacity 4 holds the 4 rows of a step, which is
   what keeps the rows independent); routing group and capacity at
   prefill and decode, slots dropped per prefill, tokens/s and peak
   memory;
5d. llama4-maverick-400b-a17b at full width, one period (a dense layer,
   then a MoE layer of 128 experts top-1 with its shared expert; ~37
   GB): 4 requests of 512 tokens, 16 new tokens each, the same checks;
5e. Jamba-1.5-large at full width (d_model 8192), one period of 8
   layers (attention at layer 4, Mamba elsewhere, 16 experts top-2 on
   the odd layers), the experts' width cut from 24576 to 3072 (~23 GB):
   4 requests of 512 and 1024 tokens, the same checks, and exactly 7
   ``selective_scan`` launches a prefill; then (6b, after phase 15a,
   whose fresh process reads its device time) the scan kernel against
   its plain version on the largest inputs those prefills gave it (Bt 1
   x L 1024 x Di 16384 x S 16, bf16), with its times and bound;
5f. internvl2-76b at full width (d_model 8192, 64/8 heads, d_ff 28672,
   vocab 128256, untied head) cut to 8 of 80 layers (~17.9 GB of random
   bf16 weights) serves 8 requests through ``launch/serve.py``'s loop (4
   slots), each with its own 256 patches (``request_inputs``) and a
   prompt of 256 or 768 tokens, 32 new tokens, ``max_seq`` 1056: each
   request equal to generation of its patches and prompt alone at the
   loop's batch; prefill and decode tokens/s, peak memory and the decode
   bound (the weights a step reads at the HBM rate);
5g. whisper-medium at full size (24 + 24 layers, bf16): 8 requests of
   1024 frames each (about 20 s of audio: the attention's 512-query
   chunking refuses Whisper's 1500), decoder prompts of 4 and 224
   tokens, 64 new tokens, ``max_seq`` 448, the cache's cross rows sized
   to the frames; the same check, and the encoder's ms per request;
   neither 5f nor 5g launches a kernel of the port;
8. the fleet engine (``fleet_engine``, one thread block per sim): the
   Seth grid, the 8 Table-2 policies x 16 seeds of the Seth stream (128
   sims of 4,000 jobs) in one ``FleetRunner().run``; seed 0 equal to
   phase 2's numpy twins job by job and in the summary counters, every
   sim's invariants, two lanes equal to their solo launches; events/s,
   the twins' events/s and the device busy share; then each of the
   run's two launches (blocking, EBF) again, ``advance`` alone on the
   padded states, timed with CUDA events (kernel ms, us per event per
   sim) and equal to the run's finals;
9. the 8 policies on the RICC-sized system (5,000 jobs): the 6 blocking
   rows to the end against numpy twins, the EBF rows against twins cut
   at 60 events (phase 3's EBF-BF twin, a new EBF-FF one); its two
   launches timed as in phase 8;
10. Seth under a seeded FAIL/REPAIR schedule with checkpoint credit, a
   quarantine and telemetry: FIFO-FF and EBF-BF equal to the host
   ``Simulator(failures=...)`` (traces, failure counters, telemetry);
11. the kernel against ``advance_plain`` (CPU, same inputs) on the
   golden scenario's 8 policies with and without the prefilter, a
   failure schedule with telemetry, and padded lanes (whole final state
   equal); its time and the plain version's on the card, and its device
   time from the profiler over 4 launches after a warm-up, in a fresh
   process;
11b. an Intrepid-sized system (ANL Intrepid, Blue Gene/P, in the
   Parallel Workloads Archive: 40,960 nodes x 4 cores x 2 GB), whose node
   arrays outgrow one block's shared memory (the kernel's global tier):
   the 8 policies on 1,000 jobs of 1 to 4096 nodes submitted over a day,
   in one ``FleetRunner().run``, every sim equal to its numpy twin run
   to the end (twins in worker processes) and its invariants; its two
   launches timed alone with CUDA events, and their device time from the
   profiler in a fresh process;
12. the Experiment layer, the paper's Table-2 study:
   ``benchmarks_torch/table2_dispatchers.run`` on the card (Seth, 8,000
   jobs, the 8 policies all on the fleet: 2 ``fleet_engine`` launches;
   plots only where matplotlib is installed), every row's job records
   and summary counters equal to the same dispatcher's through
   ``Experiment(use_fleet=False)`` on the host; then the reference
   example's three vectorized rows (FIFO-vFF, FIFO-vBF, vEBF-vFF) through
   an ``Experiment`` on the card, on the stream's first 3,000 jobs, each
   output byte-equal to its numpy twin's on those jobs;
13. a policy study: ``Experiment`` over the 8 policies x 4 repeats of a
   5,000-job ``SyntheticWorkload`` on Seth, one ``run_simulation`` (32
   sims, 2 ``fleet_engine`` launches): every row's invariants, engine
   and seed, FIFO-FF r0 and EBF-BF r0 equal to host twins; the wall
   split into planning and ``FleetRunner.build``, ``FleetRunner.run``,
   ``FleetResult.write_outputs`` and ``summaries.json``, and the device
   busy share of the whole ``run_simulation`` (profiler).  The host
   twins of phases 8-13 run in one pool of worker processes, queued
   before phase 8 (the fleet's first), while the card runs phases 8-13;
14. the benchmark modes through their entry points, on the card, each
   with its own refusal (``REPO_ROOT`` in a temporary directory):
   ``bench_dispatch.run(quick=True)`` (the three engines agree on
   ``sim_end_time``), ``bench_fleet``, ``bench_failures`` and
   ``bench_profile`` at ``quick`` (per-sim equality with the host, the
   crosscheck under failures, telemetry within its 15 % budget) and
   ``bench_kernels.run()``; one line per mode with its wall and headline
   numbers; then ``bench_kernels``' inputs at N 16384 through
   ``alloc_score`` and ``ebf_shadow`` against their plain versions, with
   their times and bounds.  Then the environment stamp of
   ``benchmarks_torch.common.bench_metadata``;
15. training on the card: smollm-360m at full size in float32, 30 steps
   of the copy task at batch 8 x 512 with ``remat="full"``, in a child
   process under deterministic algorithms (its environment sets
   ``CUBLAS_WORKSPACE_CONFIG``): finite losses that fall, and a
   checkpoint at step 25 restored and run to 30 equal bit for bit to the
   uninterrupted run; then falcon-mamba-7b at full width cut to 8
   layers, bf16, Bt 2 x L 512: exactly layers x 2 ``selective_scan``
   launches a ``remat="full"`` step and layers x micro-batches a
   ``"none"`` step, and layers x micro-batches ``selective_scan_bwd``
   launches either way, step time, tokens/s, peak memory, the scan
   backward's share of a step (timed) and the two kernels' (profiler);
   the scan against its plain version at the training shape;
16. training consistency: falcon-mamba-7b and smollm-360m at full width
   cut to 2 layers, and the qwen3-moe (2 layers), Jamba (8 layers),
   internvl2-76b and whisper-medium smoke configs (``make_batch_for``'s
   shapes), float32, TF32 off: one step (batch 2 x 64, 2
   micro-batches) on the card against the port on the CPU from the same
   parameters and data: loss within 1e-4, grads within 1e-3 of each
   leaf's max |g|, parameters within 1e-4; the MoE tokens whose top-k
   sets agree between the two sides are counted; the card's step
   launches exactly Mamba layers x micro-batches x 2 ``selective_scan``
   and Mamba layers x micro-batches ``selective_scan_bwd``;
6c. (after 16) the backward kernel (``selective_scan_bwd``) against the
   plain backward (``selective_scan_bwd_ref``) and autograd of the plain
   forward: edge cases (S 1, 5, 16 and 32, L 1, 7, 8, 9, 17, 37 and 1000,
   Di 63, 64, 65, 77 and 4001, float32, bf16, fp16 and mixed types,
   h_last used or not) through the scan's autograd, then phase 15b's and
   phase 16's Jamba largest scan inputs through the wrapper; each
   gradient within 1e-4 (float32), 1e-2 (bf16) or 1e-3 (fp16) of its
   largest magnitude in either plain version, two runs bitwise equal; its
   time, device time (phase 15a's fresh process), the plain backward's
   and the plain VJP's time, its bound, and its walk kernel's registers,
   shared memory and resident warps with the grid's waves at each shape;
15c. (after 16) qwen3-moe-30b-a3b at full width cut to 4 layers (~3.1B
   parameters), bf16, 10 steps of the copy task at batch 8 x 512 with
   ``remat="full"``: finite losses that fall, step time, tokens/s and
   peak memory beside the memory reckoned before the run;
15d. (after 15c) whisper-medium at full size, bf16, 10 steps of the copy
   task at ``make_batch_for``'s audio shapes for 1024 frames x batch 8
   (frames [8, 1024, 1024], decoder tokens [8, 128]), ``remat="full"``:
   the same checks and numbers;
17. (last) the dry-run against the card.  A child process
   (``chip_smoke.py --dryrun-child``, CPU only: a fake world of ranks and
   ``meta`` tensors, no kernel launched) dry-runs (a) a qwen3-1.7b train
   step at full size (28 layers, bf16) at 4 x 4096 tokens, 1
   micro-batch, ``remat="full"``, on a 1 x 1 mesh, and (b) phase 5's two
   falcon-mamba-7b prefills (4 x 512, 4 x 1000) with the scan as
   ``"stub"`` and as ``"ref"``; meanwhile the smoke runs 1 warm and 3
   timed steps of (a) on the card from random weights of a seeded
   generator.  It logs the median step, the peak memory, the dry-run's
   ``compute_s``, ``memory_s``, bound and per-device bytes, and each
   ratio, and fails if the measured step is shorter than ``compute_s``
   or the predicted bytes fall under half the measured peak; for (b) it
   logs both bounds beside phase 5's measured prefill times and fails if
   a prefill took less than the stub's ``compute_s``.

Phases 15-16 and 6c run right after phase 7: once the fleet phases have run,
the profiler records none of this process's kernels (phase 11 profiles
in a fresh process for that reason).  Phase 11b runs between phase 9's
fleet runs and phase 9's checks against its numpy twins, which worker
processes are still computing then.

The per-event dispatch traces of every vectorized row must equal its
numpy twin's, launches per event must stay within the batched contract,
and every kernel must have launched on its own path (the dispatch
kernels on phases 2-3, ``selective_scan`` on phases 5, 5e, 15 and 16,
``selective_scan_bwd`` on phases 15 and 16,
``fleet_engine`` on phases 8-10, 11b and on each of 12 and 13,
``alloc_score_batch`` and ``ebf_shadow`` on phase 12's vectorized rows,
the four kernels but the scan on phase 14; each path's counts are set
to 0 just before it and read just after; the kernel table's launches add
up every path).  The last two lines
are the kernel table and ``{"ok": true, "device": ...}``; any failure
exits non-zero before them.  Without a CUDA device, or outside a
checkout of the repository, it exits non-zero and prints no result.
"""
from __future__ import annotations

import concurrent.futures
import contextlib
import copy
import gc
import importlib.util
import json
import multiprocessing
import os
import random
import statistics
import subprocess
import sys
import tempfile
import time

import numpy as np
import torch

ROOT = os.path.dirname(os.path.abspath(__file__))
sys.path.insert(0, os.path.join(ROOT, "src"))
sys.path.insert(1, ROOT)

from benchmarks_torch import (bench_dispatch, bench_failures,  # noqa: E402
                              bench_fleet, bench_kernels, bench_profile,
                              table2_dispatchers)
from benchmarks_torch.common import (SETH, bench_metadata,  # noqa: E402
                                     seth_jobs)
from repro_torch.cluster import FailureInjector  # noqa: E402
from repro_torch.cluster.failures import CheckpointRestartPolicy  # noqa: E402
from repro_torch.core import Job, Simulator  # noqa: E402
from repro_torch.core.job import JobFactory  # noqa: E402
from repro_torch.core.dispatchers import (BestFit, EasyBackfilling,  # noqa: E402
                                          FirstFit, FirstInFirstOut,
                                          LongestJobFirst, ShortestJobFirst)
from repro_torch.core.dispatchers.base import SchedulerBase  # noqa: E402
from repro_torch.core.dispatchers.vectorized import (  # noqa: E402
    VectorizedAllocator, VectorizedEasyBackfilling)
from repro_torch.kernels import alloc_score as k_alloc  # noqa: E402
from repro_torch.kernels import build, counters, ops, ref  # noqa: E402
from repro_torch.kernels import ebf_shadow as k_ebf  # noqa: E402
from repro_torch.kernels import selective_scan as k_scan  # noqa: E402
from repro_torch.configs import get_config  # noqa: E402
from repro_torch.configs.base import ShapeSpec  # noqa: E402
from repro_torch.fleet import (ALLOC_BF, ALLOC_FF, ALLOC_NAMES,  # noqa: E402
                               SCHED_EBF, SCHED_FIFO, SCHED_LJF,
                               SCHED_NAMES, SCHED_SJF, FleetRunner,
                               FleetSim, SimState, advance, advance_plain,
                               stack, unstack)
from repro_torch.fleet.state import (COMPLETED, REJECTED,  # noqa: E402
                                     UNSET_I)
from repro_torch.experimentation import Experiment  # noqa: E402
from repro_torch.fleet.runner import FleetResult  # noqa: E402
from repro_torch.checkpoint import Checkpointer  # noqa: E402
from repro_torch.launch.serve import (request_inputs,  # noqa: E402
                                     serve_requests)
from repro_torch.models import build_model, moe  # noqa: E402
from repro_torch.models import params as model_params  # noqa: E402
from repro_torch.serving import (Request, RequestBatcher,  # noqa: E402
                                 greedy_generate, make_decode_step,
                                 make_prefill_step)
from repro_torch.serving.serve_step import pad_kv  # noqa: E402
from repro_torch.training import (AdamWConfig, TrainStepConfig,  # noqa: E402
                                  adamw_init, adamw_update, copy_task_batch,
                                  make_batch_for, make_train_step)
from repro_torch.training.train_step import make_grad_fn  # noqa: E402
from repro_torch.workloads.synthetic import SyntheticWorkload  # noqa: E402

# H100 SXM, NVIDIA's data sheet (see PERF.md): HBM rate, fp32 non-tensor
# rate, and exponentials (16 SFU results per clock per SM, 132 SMs at the
# 1.98 GHz boost clock)
HBM_BYTES_PER_S = 3.35e12
FP32_OPS_PER_S = 67e12
SFU_EXP_PER_S = 16 * 132 * 1.98e9

RICC = {"groups": {"ricc": {"core": 8, "mem": 12288}},
        "nodes": {"ricc": 1024}}
# the Seth stream's depth: 4,000 jobs (about four days of arrivals) keeps
# the smoke within half its time limit
SETH_JOBS = 4_000
RICC_JOBS = 5_000
RICC_MAX_EVENTS = 60
# an Intrepid-sized system: ANL Intrepid (Blue Gene/P) in the Parallel
# Workloads Archive, 40,960 nodes of 4 cores and 2 GB
INTREPID = {"groups": {"intrepid": {"core": 4, "mem": 2048}},
            "nodes": {"intrepid": 40960}}
INTREPID_JOBS = 1_000
INTREPID_SPAN_S = 24 * 3600

MAMBA_ARCH = "falcon-mamba-7b"
SERVE_SLOTS = 4
SERVE_PROMPTS = (512, 1000)     # one batch of SERVE_SLOTS requests each
SERVE_NEW_TOKENS = 32
CHECK_LAYERS = 4                # depth of the float32 consistency model
CHECK_PROMPT, CHECK_STEPS = 64, 8
DENSE_ARCH = "smollm-360m"
# the serve loop's traffic (phases 5b, 5c): SERVE_SLOTS requests of 512
# tokens, then as many of 1024; a 1000-token prompt would be refused by
# the attention's 512-query chunking
SERVE_TRAFFIC = (512,) * SERVE_SLOTS + (1024,) * SERVE_SLOTS
# training: smollm-360m at full size in a child process; falcon-mamba-7b
# at full width, cut in depth, with (remat, micro-batches) runs
TRAIN_STEPS, TRAIN_BATCH, TRAIN_SEQ, RESTART_AT = 30, 8, 512, 25
TRAIN_CHILD_FLAG = "--train-child"
MAMBA_TRAIN_LAYERS = 8
MAMBA_TRAIN_BT, MAMBA_TRAIN_L = 2, 512
MAMBA_TRAIN_RUNS = (("full", 1), ("none", 2))
MAMBA_TRAIN_STEPS = {"full": 3, "none": 1}
# phase 16: one step of batch 2 x 64 in 2 micro-batches; there Jamba's
# smoke config scans Bt 1 x L 64 x its d_inner x its states, float32
CONSIST_BATCH, CONSIST_SEQ, CONSIST_MB = 2, 64, 2
# the moe and hybrid families at full width: qwen3-moe at full size with
# phase 5b's traffic; llama4-maverick cut to one period (a dense layer,
# then a MoE layer with its shared expert: 37 GB); Jamba cut to one
# period of 8 layers with the experts' width cut from 24576 to 3072, so
# that it fits one card (23 GB; the full period takes ~84 GB)
MOE_ARCH = "qwen3-moe-30b-a3b"
MAVERICK_ARCH = "llama4-maverick-400b-a17b"
MAVERICK_CUTS = {"n_layers": 2}
MAVERICK_PROMPTS, MAVERICK_NEW_TOKENS = (512,) * SERVE_SLOTS, 16
JAMBA_ARCH = "jamba-1.5-large-398b"
JAMBA_CUTS = {"n_layers": 8, "moe_d_ff": 3072}
JAMBA_PROMPTS, JAMBA_NEW_TOKENS = (512, 512, 1024, 1024), 16
JAMBA_TRAIN_SCAN = (CONSIST_BATCH // CONSIST_MB, CONSIST_SEQ,
                    get_config(JAMBA_ARCH, smoke=True).d_inner,
                    get_config(JAMBA_ARCH, smoke=True).ssm_state)
MOE_TRAIN_LAYERS, MOE_TRAIN_STEPS = 4, 10
MOE_TRAIN_BATCH, MOE_TRAIN_SEQ = 8, 512
# the vlm and audio families: internvl2-76b at full width cut to 8 of 80
# layers (17.9 GB; whole it is 141 GB); whisper-medium at full size.  The
# attention's 512-query chunking takes 256 patches + 256 or 768 prompt
# tokens, and 1024 frames (about 20 s of audio) where Whisper's window
# has 1500
VLM_ARCH, VLM_CUTS = "internvl2-76b", {"n_layers": 8}
VLM_PROMPTS = (256,) * SERVE_SLOTS + (768,) * SERVE_SLOTS
VLM_NEW_TOKENS, VLM_MAX_SEQ = 32, 1056
AUDIO_ARCH, AUDIO_FRAMES = "whisper-medium", 1024
AUDIO_PROMPTS = (4,) * SERVE_SLOTS + (224,) * SERVE_SLOTS
AUDIO_NEW_TOKENS, AUDIO_MAX_SEQ = 64, 448      # Whisper's text context
CHECK_FRAMES = 256              # phase 7's encoder input
AUDIO_TRAIN_STEPS, AUDIO_TRAIN_BATCH = 10, 8
AUDIO_TRAIN_SHAPE = ShapeSpec("train", AUDIO_FRAMES, AUDIO_TRAIN_BATCH,
                              "train")

# kernel -> (CUDA source, TPU kernel it replaces, path that launches it)
KERNELS = {
    "alloc_score_batch": ("src/repro_torch/kernels/csrc/alloc_score.cu",
                          "src/repro/kernels/alloc_score.py:108",
                          "dispatch"),
    "alloc_score": ("src/repro_torch/kernels/csrc/alloc_score.cu",
                    "src/repro/kernels/alloc_score.py:49", "dispatch"),
    "ebf_shadow": ("src/repro_torch/kernels/csrc/ebf_shadow.cu",
                   "src/repro/kernels/ebf_shadow.py:60", "dispatch"),
    "selective_scan": ("src/repro_torch/kernels/csrc/selective_scan.cu",
                       "src/repro/kernels/selective_scan.py:61", "mamba"),
    # the reference's backward: jax.vjp of its oracle's lax.scan
    "selective_scan_bwd": (
        "src/repro_torch/kernels/csrc/selective_scan_bwd.cu",
        "src/repro/kernels/ops.py:145", "mamba"),
    "fleet_engine": ("src/repro_torch/kernels/csrc/fleet_engine.cuh",
                     "src/repro/fleet/engine.py:423", "fleet"),
}
DISPATCH_KERNELS = {k for k, v in KERNELS.items() if v[2] == "dispatch"}
# the fleet engine's sources (its fast instances and the global tier)
FLEET_SOURCES = ("fleet_engine", "fleet_engine_wide")
# device-side function names, as the profiler reports them
DEVICE_NAMES = {"alloc_score_kernel", "ebf_shadow_kernel",
                "selective_scan_kernel", "scan_bwd_kernel", "scan_bwd_reduce",
                "fleet_engine_kernel"}

# the fleet: the 8 Table-2 policies, the Seth grid's seeds, the golden
# scenario of the reference's fleet tests, and the failure schedule
POLICIES = [(sc, ac) for sc in (SCHED_FIFO, SCHED_SJF, SCHED_LJF, SCHED_EBF)
            for ac in (ALLOC_FF, ALLOC_BF)]
FLEET_SEEDS = 16
GOLDEN = {"groups": {"a": {"core": 4, "mem": 1024},
                     "b": {"core": 8, "mem": 2048}},
          "nodes": {"a": 6, "b": 4}}
GOLDEN_WL = dict(mean_interarrival_s=25.0, duration_median_s=900.0,
                 duration_sigma=1.1, node_weights={1: 0.5, 2: 0.3, 4: 0.2},
                 resources={"core": (1, 4), "mem": (64, 1024)})
FAIL_MTBF_S, FAIL_REPAIR_S, FAIL_SEED = 1_500_000.0, 7200.0, 7
QUARANTINE_S, CKPT_EVERY_S, TELE_STRIDE = 3600, 1800, 50
# the Experiment phases: the Table-2 study (benchmarks_torch's own size
# and seed) and a policy study of a synthetic workload on Seth
TABLE2_JOBS, TABLE2_SEED = 8_000, 2
# the reference example's vectorized rows (host sims that launch per
# event) run the first 3,000 jobs of that stream
TABLE2_VX_JOBS = 3_000
# 4 repeats of 5,000 jobs: within half the smoke's time limit
STUDY_JOBS, STUDY_SEED, STUDY_REPEATS = 5_000, 100, 4
STUDY_WL = dict(mean_interarrival_s=45.0, duration_median_s=1300.0,
                duration_sigma=1.5, resources={"core": (1, 4),
                                               "mem": (128, 1024)})
# numpy twins of phases 2-3, kept for the fleet phases:
# (phase, dispatcher) -> (Recorder, summary, wall seconds)
TWINS = {}
# phase 5's measured prefills, kept for phase 17: (batch, prompt) -> s
MAMBA_PREFILL_S = {}
# phase 17: a qwen3-1.7b train step on the card against its dry-run
DRYRUN_CHILD_FLAG = "--dryrun-child"
CARD_STEP_CHILD_FLAG = "--card-step-child"
DRY_ARCH = "qwen3-1.7b"
DRY_SHAPE = ShapeSpec("train_4x4096", 4096, 4, "train")
DRY_WARM, DRY_STEPS = 1, 3


T_START = time.perf_counter()


def log(obj) -> None:
    """One line of the log; a phase's line also carries ``at_s``, the
    seconds since this process started, so the log shows where the
    smoke's time limit goes."""
    if isinstance(obj, dict) and "phase" in obj:
        obj = {**obj, "at_s": round(time.perf_counter() - T_START, 1)}
    print(json.dumps(obj) if isinstance(obj, dict) else obj, flush=True)


# ----------------------------------------------------------------------
# workloads
# ----------------------------------------------------------------------
def ricc_jobs(job_cls, n, seed=1):
    """``n`` jobs submitted in per-minute batches over the first hour,
    1-32 nodes each, 10 min to 4 h, asking per core for half or all of a
    node's per-core memory share (1.5 GB)."""
    rng = random.Random(seed)
    subs = sorted(60 * rng.randrange(60) for _ in range(n))
    for i, t in enumerate(subs):
        dur = rng.randint(600, 4 * 3600)
        cores = rng.choice([1, 2, 4, 8, 8, 8])
        yield job_cls(
            id=str(i), user_id=rng.randint(1, 200), submission_time=t,
            duration=dur,
            expected_duration=min(int(dur * rng.uniform(1.0, 2.0)) + 300,
                                  6 * 3600),
            requested_nodes=rng.randint(1, 32),
            requested_resources={"core": cores,
                                 "mem": cores * rng.choice([768, 1536])})


def intrepid_jobs(job_cls, n=INTREPID_JOBS, seed=3):
    """``n`` jobs submitted uniformly over a day, each on a power of two
    of 1 to 4096 nodes, 10 min to 4 h, asking per node 1 to 4 cores and
    256 or 512 MB a core (at most a node's 4 cores and 2 GB): about 1.3
    times what the system runs in a day, so the queue builds."""
    rng = random.Random(seed)
    subs = sorted(rng.randrange(INTREPID_SPAN_S) for _ in range(n))
    for i, t in enumerate(subs):
        dur = rng.randint(600, 4 * 3600)
        cores = rng.choice([1, 2, 4, 4])
        yield job_cls(
            id=str(i), user_id=rng.randint(1, 200), submission_time=t,
            duration=dur,
            expected_duration=min(int(dur * rng.uniform(1.0, 2.0)) + 300,
                                  6 * 3600),
            requested_nodes=2 ** rng.randint(0, 12),
            requested_resources={"core": cores,
                                 "mem": cores * rng.choice([256, 512])})


# ----------------------------------------------------------------------
# instrumentation
# ----------------------------------------------------------------------
class Tap:
    """Observes the port's ``ops`` wrappers: per kernel, the peak size
    (J, M) of the current row and the largest inputs of each phase, for
    the kernel checks.  It keeps references, not copies (the inputs are
    cast to int32 only when the checks run), so it adds a size compare
    per call to the timed rows.  It launches nothing itself."""

    SIZE = {"alloc_score": lambda a: a[0].shape[0],
            "alloc_score_batch": lambda a: a[2].shape[0],
            "ebf_shadow_fits": lambda a: a[1].times.shape[0]}

    def __init__(self, ops) -> None:
        self.ops = ops
        self.orig = {name: getattr(ops, name) for name in self.SIZE}
        self.peak = {}
        self.inputs = {}          # (phase, name) -> (size, inputs)
        self.phase = None
        for name in self.SIZE:
            setattr(ops, name, self._wrap(name))

    def _wrap(self, name):
        orig, size = self.orig[name], self.SIZE[name]

        def observed(*args):
            s = size(args)
            self.peak[name] = max(self.peak.get(name, 0), s)
            key = (self.phase, name)
            if s > self.inputs.get(key, (-1,))[0]:
                self.inputs[key] = (s, args[:3])
            return orig(*args)
        return observed

    def close(self) -> None:
        for name, fn in self.orig.items():
            setattr(self.ops, name, fn)


class Recorder(SchedulerBase):
    """Wraps a planner; keeps per event (time, trace) and the launches and
    greedy probes the plan cost."""

    def __init__(self, inner) -> None:
        super().__init__(inner.allocator)
        self.inner = inner
        self.name = inner.name
        self.traces, self.launches, self.trips = [], [], []
        self.queues = []          # queued jobs at each dispatch event

    def plan(self, ctx):
        self.queues.append(len(ctx.n_nodes))
        l0 = counters.launch_count()
        plan = self.inner.plan(ctx)
        self.launches.append(counters.launch_count() - l0)
        self.trips.append(plan.stats["phase_counters"]["dispatch_trips"])
        self.traces.append((ctx.now, plan.trace()))
        return plan


def device_time_us(prof):
    """(our kernels' device time, all device time) of a profile, in us."""
    ours = total = 0.0
    for ev in prof.key_averages():
        t = getattr(ev, "self_device_time_total", None)
        if t is None:
            t = getattr(ev, "self_cuda_time_total", 0.0)
        total += t
        if any(k in ev.key for k in DEVICE_NAMES):
            ours += t
    return ours, total


# ----------------------------------------------------------------------
# phases
# ----------------------------------------------------------------------
def run_pair(tap, system, jobs, label, vx_sched, np_sched, kind,
             max_events=None, profile=False):
    """Run ``vx_sched`` (CUDA) and its numpy twin on the same workload and
    hold their per-event traces equal; returns the row's numbers.  Both
    timed runs go without the profiler.  With ``profile`` the CUDA row is
    run a second time under ``torch.profiler`` for its device time, and
    that run's traces are held equal too."""
    runs = [("cuda", vx_sched, False), ("numpy", np_sched, False)]
    if profile:
        runs.append(("cuda_profiled", vx_sched, True))
    rows = {}
    for engine, sched, traced in runs:
        rec = Recorder(sched)
        tap.peak = {}
        with tempfile.TemporaryDirectory() as td:
            sim = Simulator(jobs(Job), system, rec, output_dir=td,
                            name=label)
            with (torch.profiler.profile(
                    activities=[torch.profiler.ProfilerActivity.CUDA])
                  if traced else contextlib.nullcontext()) as prof:
                t0 = time.perf_counter()
                sim.start_simulation(write_output=False,
                                     max_events=max_events)
                torch.cuda.synchronize()
                wall = time.perf_counter() - t0
        rows[engine] = (rec, sim.summary, wall, dict(tap.peak), prof)
    rec, summ, wall, peak, _ = rows["cuda"]
    twin, twin_summ, twin_wall, _, _ = rows["numpy"]
    TWINS[(tap.phase, np_sched.dispatcher_name)] = (twin, twin_summ,
                                                    twin_wall)
    for engine in rows:
        got = rows[engine][0].traces
        if got != twin.traces:
            first = next(i for i, (a, b) in enumerate(zip(got, twin.traces))
                         if a != b) if len(got) == len(twin.traces) \
                else min(len(got), len(twin.traces))
            raise AssertionError(f"{label} ({engine}): per-event traces "
                                 f"diverge from the numpy twin at dispatch "
                                 f"event {first}")
    for k in ("events", "submitted", "completed", "rejected",
              "sim_end_time"):
        if summ[k] != twin_summ[k]:
            raise AssertionError(f"{label}: summary {k} {summ[k]} != "
                                 f"{twin_summ[k]}")
    lp = np.asarray(rec.launches)
    if kind == "batched" and not np.all(lp == 1):
        raise AssertionError(f"{label}: launches per event {set(lp)} != 1")
    if kind == "ebf" and not (np.all(lp >= 1) and np.all(lp <= 3)):
        raise AssertionError(f"{label}: launches per event outside [1, 3]")
    if kind == "per_job" and not np.array_equal(lp, rec.trips):
        raise AssertionError(f"{label}: per-job launches != probes")
    out = {"row": label, "events": summ["events"],
           "dispatch_events": len(rec.traces),
           "starts": sum(len(t) for _, t in rec.traces),
           "wall_s": wall, "events_per_s": summ["events"] / wall,
           "dispatch_s_per_event": summ["dispatch_time_s"] / summ["events"],
           "launches_per_event": summ["kernel_launches_per_event"],
           "max_launches_in_an_event": int(lp.max()),
           "peak_J": peak.get("alloc_score_batch"),
           "peak_M": peak.get("ebf_shadow_fits"),
           "twin_wall_s": twin_wall,
           "twin_events_per_s": twin_summ["events"] / twin_wall,
           "traces_equal": True}
    if profile:
        # the profiled run does the same device work; its shares are of
        # the unprofiled wall, and its own wall shows the profiler's cost
        _, _, prof_wall, _, prof = rows["cuda_profiled"]
        ours, total = device_time_us(prof)
        out["kernel_share_of_wall"] = ours * 1e-6 / wall
        out["device_busy_share"] = total * 1e-6 / wall
        out["profiled_wall_s"] = prof_wall
    return out


def check(name, fn, plain, cases, tol=None):
    """Hold the kernel ``fn`` against ``plain`` on every case (CUDA
    tensors); returns the largest absolute difference.  With ``tol`` None
    the outputs must be equal (float32 bitwise); else within
    ``atol = rtol = tol``."""
    err = 0.0
    for args in cases:
        got, want = fn(*args), plain(*args)
        torch.cuda.synchronize()
        got = got if isinstance(got, tuple) else (got,)
        want = want if isinstance(want, tuple) else (want,)
        for g, w in zip(got, want):
            if g.shape != w.shape or g.dtype != w.dtype:
                raise AssertionError(f"{name}: {g.shape}/{g.dtype} != "
                                     f"{w.shape}/{w.dtype}")
            if tol is not None:
                if not torch.allclose(g, w, rtol=tol, atol=tol):
                    raise AssertionError(f"{name}: not within {tol} of the "
                                         f"plain version")
            elif g.dtype == torch.float32:
                if not torch.equal(g.view(torch.int32), w.view(torch.int32)):
                    raise AssertionError(f"{name}: float output not "
                                         f"bitwise equal")
            elif not torch.equal(g, w):
                raise AssertionError(f"{name}: integer output differs")
            if g.numel():
                err = max(err, float((g.double() - w.double()).abs().max()))
    return err


def device_ms(fn, reps=20):
    """Device time per call from the profiler: (our kernels' time, all
    device time).  Unlike ``time_ms`` it excludes the host's enqueue
    cost, which bounds back-to-back calls of a small kernel."""
    fn()
    torch.cuda.synchronize()
    with torch.profiler.profile(
            activities=[torch.profiler.ProfilerActivity.CUDA]) as prof:
        for _ in range(reps):
            fn()
        torch.cuda.synchronize()
    ours, total = device_time_us(prof)
    return ours * 1e-3 / reps, total * 1e-3 / reps


def time_ms(fn, reps=20, rounds=7):
    """Median over rounds of CUDA-event time per call, warm."""
    fn()
    torch.cuda.synchronize()
    per = []
    for _ in range(rounds):
        start = torch.cuda.Event(enable_timing=True)
        end = torch.cuda.Event(enable_timing=True)
        start.record()
        for _ in range(reps):
            fn()
        end.record()
        end.synchronize()
        per.append(start.elapsed_time(end) / reps)
    return statistics.median(per)


def bound(name, shapes):
    """(bound_ms, bound_by): the larger of bytes / HBM rate and the
    operations' time (fp32 operations at the fp32 peak; the scan's
    exponentials at the SFU rate, whichever is longer), for one call at
    these shapes (int32 and float32 are 4 bytes, the scan's u, delta, B
    and C are counted at their element size; inputs read once, outputs
    written once)."""
    t_exp = 0.0
    if name == "fleet_engine":                    # the batch's SimState
        nbytes, ops = 2 * shapes[0], 0            # read once, written once
    elif name == "ebf_shadow":                    # sparse, grouped by node
        m, n, r, nnz = shapes
        nbytes = 4 * (n * r + r + n + 1 + nnz * (1 + r) + m)
        ops = 2 * (n + nnz) * r + m               # adds, compares; scan
    elif name == "selective_scan":
        bt, length, di, s, e = shapes             # e: bytes of u, delta, B, C
        nbytes = (e * (2 * bt * length * di + 2 * bt * length * s)
                  + 4 * (bt * length * di + di * s + di + bt * di * s))
        ops = 6 * bt * length * di * s            # mul, 2 fma, mul, fma, add
        t_exp = bt * length * di * s / SFU_EXP_PER_S
    elif name == "selective_scan_bwd":
        # reads u, delta, B, C (e bytes), gy, gh, A, D (float32); writes
        # du, ddelta, dB, dC (e bytes), dA, dD (float32); one exponential
        # and 14 operations per (b, t, d, s) (the walk back: G, h_{t-1} a,
        # the ddelta, du, dB, dC and dA terms, the carry)
        bt, length, di, s, e = shapes
        nbytes = (e * 2 * (2 * bt * length * di + 2 * bt * length * s)
                  + 4 * (bt * length * di + bt * di * s
                         + 2 * (di * s + di)))
        ops = 14 * bt * length * di * s
        t_exp = bt * length * di * s / SFU_EXP_PER_S
    else:                                         # fit bits + score [N]
        j, n, r = shapes
        nbytes = 4 * (j * r + 2 * n * r + j * -(-n // 32) + n)
        ops = j * n * r + 5 * n * r               # compares; score once
    t_bytes = nbytes / HBM_BYTES_PER_S
    t_ops = max(ops / FP32_OPS_PER_S, t_exp)
    return (max(t_bytes, t_ops) * 1e3,
            "bytes" if t_bytes >= t_ops else "operations")


def kernel_rows(name, fn, plain, phase_inputs, extra, launches, shapes_of,
                tol=None, reps=200, plain_reps=20, plain_rounds=7,
                plain_device_reps=20, device=None):
    """Check one kernel against its plain version on every phase's largest
    inputs and on ``extra`` cases, then, per phase, time both at that
    phase's inputs and log the phase's row (``launches`` maps phase to
    its CUDA launches).  Returns the kernel-table row of the last phase
    (the largest inputs), with the launches of all phases.  ``device``,
    where given, is the kernel's device ms read elsewhere (a fresh
    process) in place of this process's profiler."""
    err = check(name, fn, plain, list(phase_inputs.values()) + extra, tol)
    src, replaces, _ = KERNELS[name]
    for phase, args in phase_inputs.items():
        shapes = shapes_of(args)
        ms = time_ms(lambda: fn(*args), reps)
        plain_ms = time_ms(lambda: plain(*args), plain_reps, plain_rounds)
        ours = device if device is not None else \
            device_ms(lambda: fn(*args), reps)[0]
        b_ms, b_by = bound(name, shapes)
        log({"phase": "kernel", "name": name, "path": phase,
             "cases": len(phase_inputs) + len(extra), "shape": list(shapes),
             "launches": launches.get(phase, 0), "ms": ms,
             "plain_ms": plain_ms,
             "device_ms": ours if ours > 0 else "not measured",
             "plain_device_ms": device_ms(lambda: plain(*args),
                                          plain_device_reps)[1],
             "bound_ms": b_ms, "bound_by": b_by, "max_abs_err": err})
    return {"name": name, "route": "cuda", "source": src,
            "replaces": replaces, "launches": sum(launches.values()),
            "max_abs_err": err, "ms": ms, "plain_ms": plain_ms,
            "bound_ms": b_ms, "bound_by": b_by, "library_ms": None}


def alloc_one_plain(a, c, q):
    """``alloc_score``'s plain version for one request ``q [R]``."""
    bits, score = ref.alloc_score_packed_ref(a, c, q.view(1, -1))
    return bits[0], score


def to_dev(x, dev):
    return torch.from_numpy(np.ascontiguousarray(x, dtype=np.int32)).to(dev)


def floored_system(rng, n, r, j):
    """Ragged N, -1-floored rows (ineligible nodes) and zero request
    columns, as host arrays (avail, capacity, req [J, R])."""
    cap = rng.integers(1, 16, (n, r))
    avail = rng.integers(0, 16, (n, r)).clip(0, cap)
    avail[rng.choice(n, size=max(1, n // 10), replace=False)] = -1
    req = rng.integers(0, 6, (j, r))
    req[::2, 0] = 0                     # floored rows must not fit anyway
    return avail, cap, req


def release_tuples(rng, n, r, n_rel, n_times, k_max, low=0, high=3):
    """Sorted ``(time, nodes, vec)`` releases: k <= n distinct nodes per
    job, times from ``n_times`` values (ties)."""
    out = []
    for _ in range(n_rel):
        k = int(rng.integers(1, min(k_max, n) + 1))
        out.append((int(rng.integers(0, n_times)),
                    rng.choice(n, size=k, replace=False),
                    rng.integers(low, high, r)))
    out.sort(key=lambda e: e[0])
    return out


def ebf_args(avail, rel, req, dev):
    """The ebf_shadow kernel's arguments: avail, node_ptr, entry_m,
    entry_vec, req on ``dev``, and M."""
    r = np.shape(avail)[1]
    return (to_dev(avail, dev), to_dev(rel.node_ptr, dev),
            to_dev(rel.entry_m, dev),
            to_dev(np.reshape(rel.entry_vec, (-1, r)), dev),
            to_dev(req, dev), rel.times.shape[0])


def transfers(name, call, calls=20):
    """Copies per ``ops`` call, read from the profiler (memcpy records by
    direction; more than one each way per call fails), and the call's
    host wall time (unprofiled), in ms."""
    call()
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    for _ in range(calls):
        call()
    wall_ms = (time.perf_counter() - t0) * 1e3 / calls
    with torch.profiler.profile(
            activities=[torch.profiler.ProfilerActivity.CUDA]) as prof:
        for _ in range(calls):
            call()
        torch.cuda.synchronize()
    count = {"h2d": 0, "d2h": 0}
    for ev in prof.key_averages():
        key = ev.key.lower()
        for kind, tag in (("h2d", "htod"), ("d2h", "dtoh")):
            if "memcpy" in key and tag in key:
                count[kind] += ev.count
    if max(count.values()) > calls:
        raise AssertionError(f"{name}: more than one copy each way per "
                             f"call: {count} in {calls} calls")
    return {f"{k}_copies_per_call": v / calls for k, v in count.items()} | {
        "ops_call_ms": wall_ms}


class ApplyTap:
    """Wraps one model's ``apply``: counts calls and tokens by mode, and
    keeps on the card a flag that every call's last-position logits were
    finite, read once by ``close``.  Untimed, it adds no host synchronise
    to the path; ``timed`` also takes each call's host time between two
    synchronises, for the prefill/decode split."""

    def __init__(self, model, timed: bool = False) -> None:
        self.model, self.orig, self.timed = model, model.apply, timed
        self.secs = {"prefill": 0.0, "decode": 0.0}
        self.tokens = {"prefill": 0, "decode": 0}
        self.calls = {"prefill": 0, "decode": 0}
        self.finite = None
        model.apply = self._wrapped

    def _wrapped(self, params, batch, *, mode="train", cache=None, **kw):
        if self.timed:
            torch.cuda.synchronize()
        t0 = time.perf_counter()
        logits, cache = self.orig(params, batch, mode=mode, cache=cache,
                                  **kw)
        if self.timed:
            torch.cuda.synchronize()
            self.secs[mode] += time.perf_counter() - t0
        self.tokens[mode] += batch["tokens"].numel()
        self.calls[mode] += 1
        ok = torch.isfinite(logits[:, -1]).all()
        self.finite = ok if self.finite is None else self.finite & ok
        return logits, cache

    def snapshot(self) -> dict:
        return {k: dict(getattr(self, k)) for k in ("secs", "tokens", "calls")}

    def close(self, label="mamba") -> None:
        del self.model.apply
        if self.finite is None or not bool(self.finite):
            raise AssertionError(f"{label}: non-finite logits")


class ScanTap:
    """Keeps (references to) the largest inputs ``ops.selective_scan``
    was given, for the kernel check; launches nothing itself."""

    def __init__(self) -> None:
        self.orig, self.largest = ops.selective_scan, None
        ops.selective_scan = self._observed

    def _observed(self, *args):
        if self.largest is None or args[0].numel() > self.largest[0].numel():
            self.largest = args
        return self.orig(*args)

    def close(self) -> None:
        ops.selective_scan = self.orig


def serve_mamba(dev):
    """Phase 5: falcon-mamba-7b at full width serves 8 requests in two
    batches of 4 through the batcher and ``greedy_generate``.  Returns
    the CUDA launches of the serve run and the scan's largest inputs."""
    cfg = get_config(MAMBA_ARCH)
    torch.cuda.reset_peak_memory_stats()
    model = build_model(cfg, dev)
    t0 = time.perf_counter()
    params = model.init_params(seed=0)
    torch.cuda.synchronize()
    log({"phase": "mamba", "arch": cfg.name, "n_layers": cfg.n_layers,
         "d_model": cfg.d_model, "d_inner": cfg.d_inner,
         "ssm_state": cfg.ssm_state, "dt_rank": cfg.dtr,
         "vocab": cfg.vocab_size, "dtype": cfg.dtype,
         "weights_gb": sum(p.numel() * p.element_size()
                           for p in params.parameters()) / 1e9,
         "init_s": time.perf_counter() - t0})

    rng = np.random.default_rng(0)
    batcher = RequestBatcher(SERVE_SLOTS)
    for length in SERVE_PROMPTS:
        for i in range(SERVE_SLOTS):
            batcher.submit(Request(
                id=f"{length}-{i}", max_new_tokens=SERVE_NEW_TOKENS,
                prompt=rng.integers(0, cfg.vocab_size, length).tolist()))
    # warm-up outside every count and timer: the first call of each
    # library (cuBLAS, the scan kernel) pays a one-time cost
    greedy_generate(model, params, {"tokens": torch.zeros(
        (SERVE_SLOTS, 8), dtype=torch.int32, device=dev)}, 2)

    # the counted run: each greedy_generate call is timed whole, with one
    # synchronise at each end and none inside, as a caller runs it
    calls, tap = ApplyTap(model), ScanTap()
    counters.reset_device_launches()
    t0 = time.perf_counter()
    served = []
    while not batcher.idle:
        admitted = batcher.admit()
        prompts = torch.tensor([r.prompt for r in admitted],
                               dtype=torch.int32, device=dev)
        torch.cuda.synchronize()
        t1 = time.perf_counter()
        out = greedy_generate(model, params, {"tokens": prompts},
                              SERVE_NEW_TOKENS)
        torch.cuda.synchronize()
        generate_s = time.perf_counter() - t1
        out = out.cpu()
        if out.shape != (len(admitted), SERVE_NEW_TOKENS) or \
                int(out.min()) < 0 or int(out.max()) >= cfg.vocab_size:
            raise AssertionError(f"mamba: bad tokens {tuple(out.shape)}")
        for step in range(out.shape[1]):
            batcher.record_tokens({r.slot: int(out[k, step])
                                   for k, r in enumerate(admitted)})
        served.append((prompts, out, generate_s))
    wall = time.perf_counter() - t0
    launches = counters.device_launch_stats()
    calls.close()
    tap.close()

    done = batcher.completed
    if len(done) != 2 * SERVE_SLOTS or any(
            len(r.generated) != SERVE_NEW_TOKENS for r in done):
        raise AssertionError("mamba: not every request was served")
    prefills = calls.calls["prefill"]
    if prefills != len(SERVE_PROMPTS) or launches != {
            "selective_scan": cfg.n_layers * prefills}:
        raise AssertionError(f"mamba: {prefills} prefills, CUDA launches "
                             f"{launches}; expected {cfg.n_layers} "
                             f"selective_scan launches per prefill")

    # the prefill/decode split: the same batches again, each model call
    # between two synchronises.  Decode time is the counted run's whole
    # call less this prefill; the per-call synced decode time shows what
    # the synchronises cost.
    timer = ApplyTap(model, timed=True)
    tot = {"prefill_tokens": 0, "prefill_s": 0.0, "decode_tokens": 0,
           "decode_s": 0.0, "decode_synced_s": 0.0}
    for prompts, out, generate_s in served:
        before = timer.snapshot()
        again = greedy_generate(model, params, {"tokens": prompts},
                                SERVE_NEW_TOKENS).cpu()
        d = {k: {m: getattr(timer, k)[m] - before[k][m] for m in before[k]}
             for k in before}
        b, n = prompts.shape
        prefill_s = d["secs"]["prefill"]
        MAMBA_PREFILL_S[(b, n)] = prefill_s
        decode_tokens = d["tokens"]["decode"]
        decode_s = generate_s - prefill_s
        log({"phase": "mamba", "batch": b, "prompt_len": n,
             "generate_s": generate_s, "prefill_s": prefill_s,
             "prefill_tokens_per_s": b * n / prefill_s,
             "decode_steps": d["calls"]["decode"], "decode_s": decode_s,
             "decode_tokens_per_s": decode_tokens / decode_s,
             "decode_synced_per_call_s": d["secs"]["decode"],
             "decode_synced_per_call_tokens_per_s":
             decode_tokens / d["secs"]["decode"],
             "same_tokens_again": bool(torch.equal(again, out))})
        tot["prefill_tokens"] += b * n
        tot["prefill_s"] += prefill_s
        tot["decode_tokens"] += decode_tokens
        tot["decode_s"] += decode_s
        tot["decode_synced_s"] += d["secs"]["decode"]
    timer.close()

    log({"phase": "mamba", "prefill_tokens_per_s":
         tot["prefill_tokens"] / tot["prefill_s"]})
    log({"phase": "mamba", "decode_tokens_per_s":
         tot["decode_tokens"] / tot["decode_s"]})
    log({"phase": "mamba", "decode_synced_per_call_tokens_per_s":
         tot["decode_tokens"] / tot["decode_synced_s"]})
    log({"phase": "mamba", "peak_memory_gb":
         torch.cuda.max_memory_allocated() / 1e9})
    log({"phase": "mamba", "selective_scan_cuda_launches":
         launches["selective_scan"], "per_prefill":
         launches["selective_scan"] / prefills})
    log({"phase": "mamba", "requests": len(done), "wall_s": wall,
         "generated_tokens": sum(len(r.generated) for r in done)})
    profile_serving(model, params, dev, cfg.vocab_size)
    return launches["selective_scan"], tap.largest


MATMUL_NAMES = ("gemm", "gemv", "nvjet", "xmma", "cutlass")


def profile_serving(model, params, dev, vocab):
    """Where the serving time goes: one prefill of the largest batch and
    CHECK_STEPS decode steps under ``torch.profiler``, after the counted
    run.  Device time is split into the scan kernel, matrix products
    (cuBLAS kernels by name) and the rest, as shares of the host wall."""
    rng = np.random.default_rng(4)
    prompts = torch.from_numpy(rng.integers(
        0, vocab, (SERVE_SLOTS, max(SERVE_PROMPTS))).astype(np.int32)).to(dev)
    prefill = make_prefill_step(model)
    state = {}

    def run_prefill():
        state["logits"], state["cache"] = prefill(params, {"tokens": prompts})

    @torch.no_grad()
    def run_decode():
        tok = torch.argmax(state["logits"], -1).to(torch.int32)[:, None]
        for _ in range(CHECK_STEPS):
            logits, state["cache"] = model.apply(
                params, {"tokens": tok}, mode="decode", cache=state["cache"])
            tok = torch.argmax(logits[:, -1], -1).to(torch.int32)[:, None]

    for label, fn in (("prefill", run_prefill), ("decode", run_decode)):
        torch.cuda.synchronize()
        with torch.profiler.profile(
                activities=[torch.profiler.ProfilerActivity.CUDA]) as prof:
            t0 = time.perf_counter()
            fn()
            torch.cuda.synchronize()
            wall = time.perf_counter() - t0
        by = {"scan": 0.0, "matmul": 0.0, "other": 0.0}
        top = []
        for ev in prof.key_averages():
            t = getattr(ev, "self_device_time_total", None)
            if t is None:
                t = getattr(ev, "self_cuda_time_total", 0.0)
            if t <= 0:
                continue
            top.append((t, ev.key[:60]))
            key = ev.key.lower()
            kind = "scan" if "selective_scan_kernel" in key else \
                "matmul" if any(m in key for m in MATMUL_NAMES) else "other"
            by[kind] += t * 1e-6
        log({"phase": "mamba_profile", "part": label, "wall_s": wall,
             "device_busy_share": sum(by.values()) / wall,
             **{f"{k}_share": v / wall for k, v in by.items()},
             "top_kernels_ms": [[k, t * 1e-3] for t, k in sorted(top)[::-1][:6]]})


def scan_case(rng, dev, bt, length, di, s, dtype=torch.float32):
    """Random scan inputs on ``dev``: small positive delta, negative A;
    u, delta, B and C in ``dtype``, A and D in float32 (as the model)."""
    u = rng.standard_normal((bt, length, di))
    dt = np.abs(rng.standard_normal((bt, length, di))) * 0.1
    A = -np.abs(rng.standard_normal((di, s)))
    B = rng.standard_normal((bt, length, s))
    C = rng.standard_normal((bt, length, s))
    D = rng.standard_normal((di,))
    return tuple(torch.from_numpy(x.astype(np.float32)).to(dev).to(
        torch.float32 if i in (2, 5) else dtype)
        for i, x in enumerate((u, dt, A, B, C, D)))


def bwd_case(rng, dev, bt, length, di, s, dtype=torch.float32,
             gh_zero=True):
    """``scan_case``'s inputs and the cotangents of y (float32, normal)
    and h_last (zeros, as a training step gives them, or normal)."""
    gy = torch.from_numpy(rng.standard_normal((bt, length, di)).astype(
        np.float32)).to(dev)
    gh = torch.from_numpy(rng.standard_normal((bt, di, s)).astype(
        np.float32)).to(dev)
    return scan_case(rng, dev, bt, length, di, s, dtype) + (
        gy, torch.zeros_like(gh) if gh_zero else gh)


# (Bt, L, Di, S, type): S past the 4-state groups (1, 5, 13), Di past the
# 64-channel tile and the 16-byte rows (77, 4001, 8190), L short of and
# past the 32-step chunk (1, 3, 37, 1000), each input type
SCAN_CASES = ((1, 1, 77, 16, torch.float32), (2, 3, 8190, 1, torch.bfloat16),
              (2, 37, 4001, 5, torch.float16),
              (2, 1000, 4001, 13, torch.bfloat16),
              (4, 1000, 8192, 1, torch.float32),
              (1, 1000, 77, 5, torch.float16),
              (3, 37, 8190, 13, torch.float32))


def check_scan(dev, served, launches):
    """Phase 6: the scan kernel against its plain version on the serve
    run's largest inputs plus ragged S, Di and L in every input type,
    within 1e-4; and on the narrow cases, bitwise against itself on the
    same values upcast to float32 (the native read is exact)."""
    rng = np.random.default_rng(2)
    cases = [scan_case(rng, dev, *shape) for shape in SCAN_CASES]
    narrow = [served] + [c for c in cases if c[0].dtype != torch.float32]
    check("selective_scan", k_scan.selective_scan,
          lambda *a: k_scan.selective_scan(*[x.float() for x in a]), narrow)
    log({"phase": "kernel", "name": "selective_scan",
         "check": "native read equals float32 upcast, bitwise",
         "cases": [[*c[0].shape, c[2].shape[1], str(c[0].dtype)]
                   for c in narrow]})
    return kernel_rows("selective_scan", k_scan.selective_scan,
                       ref.selective_scan_ref, {"serve": served}, cases,
                       {"serve": launches},
                       lambda a: tuple(a[0].shape) + (
                           a[2].shape[1], a[0].element_size()),
                       tol=1e-4, reps=20, plain_reps=2, plain_rounds=3,
                       plain_device_reps=2)


# (Bt, L, Di, S, u/delta/B/C types, h_last used): S 5, 16 and 32 (two
# launches), L 1 and past the chunks, Di 4001 and past the 64-channel
# tile, every input type and a mix (cast to float32, each gradient back
# to its input's type); then the kernel's edges: L one short of, at and
# one past its 8-step chunk and one past two stages (7, 8, 9, 17), Di one
# short of and past the tile (63, 65), S 1 and 16
BWD_MIXED = (torch.bfloat16, torch.bfloat16, torch.float16, torch.float32)
BWD_CASES = ((2, 37, 64, 5, (torch.float32,) * 4, True),
             (2, 37, 64, 16, (torch.bfloat16,) * 4, False),
             (2, 130, 4001, 32, (torch.float16,) * 4, True),
             (1, 1, 4001, 16, BWD_MIXED, True),
             (3, 1, 77, 5, (torch.float32,) * 4, False),
             (1, 1000, 77, 13, (torch.bfloat16,) * 4, True),
             (1, 7, 63, 16, (torch.float32,) * 4, True),
             (2, 8, 65, 1, (torch.bfloat16,) * 4, False),
             (1, 9, 63, 16, (torch.float16,) * 4, True),
             (2, 17, 65, 16, BWD_MIXED, True),
             (2, 17, 63, 1, (torch.float32,) * 4, False))
#: each gradient within this share of its largest magnitude in the plain
#: backward, by its dtype (narrow types: one unit of rounding apart)
GRAD_TOL = {torch.float32: 1e-4, torch.bfloat16: 1e-2, torch.float16: 1e-3}


def scan_grads(run, args, gy, gh, with_h=True):
    """The six scan inputs' gradients through ``run`` under autograd
    (``with_h`` False: ``h_last`` unused)."""
    xs = [x.detach().clone().requires_grad_() for x in args]
    y, h = run(*xs)
    torch.autograd.backward((y, h) if with_h else (y,),
                            (gy, gh) if with_h else (gy,))
    return [x.grad for x in xs]


def hold_grads(label, got, again, wants):
    """``got`` bitwise equal to ``again`` (a second run), and each
    gradient in its input's dtype within ``GRAD_TOL`` of its largest
    magnitude in every one of ``wants``: (largest absolute error, largest
    error over that magnitude)."""
    err = rel = 0.0
    for i, (g, g2) in enumerate(zip(got, again)):
        if not torch.equal(g, g2):
            raise AssertionError(f"selective_scan_bwd ({label}): gradient "
                                 f"{i} differs between two runs")
        for w in wants:
            if g.dtype != w[i].dtype or g.shape != w[i].shape:
                raise AssertionError(f"selective_scan_bwd ({label}): "
                                     f"gradient {i} {g.dtype}/{g.shape}, "
                                     f"plain {w[i].dtype}/{w[i].shape}")
            scale = max(float(w[i].abs().max()), 1e-30)
            e = float((g.double() - w[i].double()).abs().max())
            if e > GRAD_TOL[g.dtype] * scale:
                raise AssertionError(f"selective_scan_bwd ({label}): "
                                     f"gradient {i} off by {e}, over "
                                     f"{GRAD_TOL[g.dtype]} of {scale}")
            err, rel = max(err, e), max(rel, e / scale)
    return err, rel


def check_scan_bwd(dev, paths, launches, device):
    """Phase 6c: the backward kernel's gradients (through autograd of
    ``selective_scan``: forward and backward kernels) against the plain
    backward (``selective_scan_bwd_ref``) and autograd of the plain
    forward on ``BWD_CASES``; then, on each path's largest scan inputs
    (``paths``: phase 15b's training, phase 16's Jamba step) with the
    cotangents a step gives (y's, and zeros for the unused h_last), the
    wrapper ``selective_scan_bwd`` against both, two runs bitwise equal,
    its time, its device time (``device``, read in phase 15a's fresh
    process), the plain backward's and the plain VJP's (what the card ran
    before the kernel), and its bound.  Returns the kernel-table row of
    the first path, with the launches of all (``launches``)."""
    t_phase = time.perf_counter()
    rng = np.random.default_rng(8)
    for bt, length, di, s, types, with_h in BWD_CASES:
        base = bwd_case(rng, dev, bt, length, di, s, gh_zero=not with_h)
        args = tuple(x.to(t) for x, t in zip(base[:6], (
            types[0], types[1], torch.float32, types[2], types[3],
            torch.float32)))
        gy, gh = base[6:]
        got = scan_grads(k_scan.selective_scan, args, gy, gh, with_h)
        again = scan_grads(k_scan.selective_scan, args, gy, gh, with_h)
        hold_grads(f"Bt {bt} L {length} Di {di} S {s}", got, again, (
            ref.selective_scan_bwd_ref(*args, gy, gh),
            scan_grads(ref.selective_scan_ref, args, gy, gh, with_h)))
    log({"phase": "kernel", "name": "selective_scan_bwd",
         "check": "edge cases within GRAD_TOL, bitwise repeatable",
         "cases": [[bt, length, di, s, [str(t) for t in types], with_h]
                   for bt, length, di, s, types, with_h in BWD_CASES]})
    row = None
    for path, inputs in paths.items():
        u = inputs[0]
        gy = torch.from_numpy(rng.standard_normal(tuple(u.shape)).astype(
            np.float32)).to(dev)
        gh = torch.zeros((u.shape[0], u.shape[2], inputs[2].shape[1]),
                         dtype=torch.float32, device=dev)
        args = tuple(inputs) + (gy, gh)
        kernel = lambda: k_scan.selective_scan_bwd(*args)
        err, rel = hold_grads(path, kernel(), kernel(), (
            ref.selective_scan_bwd_ref(*args),
            scan_grads(ref.selective_scan_ref, inputs, gy, gh)))
        shapes = tuple(u.shape) + (inputs[2].shape[1], u.element_size())
        ms = time_ms(kernel, 20)
        plain_ms = time_ms(lambda: ref.selective_scan_bwd_ref(*args), 1, 3)
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        scan_grads(ref.selective_scan_ref, inputs, gy, gh)
        torch.cuda.synchronize()
        vjp_ms = (time.perf_counter() - t0) * 1e3
        b_ms, b_by = bound("selective_scan_bwd", shapes)
        sms = torch.cuda.get_device_properties(dev).multi_processor_count
        for aligned in (True, False):
            att = k_scan.bwd_kernel_attributes(u.dtype, dev, aligned)
            grid = -(-u.shape[2] // att["channels_per_block"]) * u.shape[0]
            log({"phase": "build", "kernel": "selective_scan_bwd",
                 "path": path, "dtype": str(u.dtype), "aligned": aligned,
                 **att, "grid_blocks": grid, "sms": sms,
                 "waves": grid / (att["blocks_per_sm"] * sms)})
        log({"phase": "kernel", "name": "selective_scan_bwd", "path": path,
             "shape": list(shapes), "dtype": str(u.dtype),
             "cases": len(BWD_CASES) + len(paths),
             "launches": launches.get(path, 0), "ms": ms,
             "device_ms": device.get(path, 0.0) or "not measured",
             "plain_ms": plain_ms, "plain_vjp_ms": vjp_ms,
             "bound_ms": b_ms, "bound_by": b_by, "max_abs_err": err,
             "max_err_of_largest": rel})
        if row is None:
            src, replaces, _ = KERNELS["selective_scan_bwd"]
            row = {"name": "selective_scan_bwd", "route": "cuda",
                   "source": src, "replaces": replaces,
                   "launches": sum(launches.values()), "max_abs_err": err,
                   "ms": ms, "plain_ms": plain_ms, "bound_ms": b_ms,
                   "bound_by": b_by, "library_ms": None}
        row["max_abs_err"] = max(row["max_abs_err"], err)
    log({"phase": "kernel", "name": "selective_scan_bwd",
         "wall_s": time.perf_counter() - t_phase})
    return row


def check_consistency(dev):
    """Phase 7: prefill + decode against teacher forcing, in float32 at
    full width, cut to CHECK_LAYERS layers: falcon-mamba-7b, then
    smollm-360m with its KV cache in float32 (within 5e-4) and in int8
    (within the reference's 0.15 relative error, ``test_models.py``);
    then the smoke configs of qwen3-moe, llama4-maverick and Jamba with
    ``capacity_factor`` 16, so that no token drops (the reference's
    ``test_prefill_decode_matches_teacher_forcing``), within 5e-4."""
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    for arch, kv in ((MAMBA_ARCH, ""), (DENSE_ARCH, ""), (DENSE_ARCH, "int8")):
        consistency_of(dev, get_config(arch).replace(
            n_layers=CHECK_LAYERS, dtype="float32", kv_cache_dtype=kv),
            f"n_layers {CHECK_LAYERS} of {get_config(arch).n_layers}, "
            f"float32")
    for arch in (MOE_ARCH, MAVERICK_ARCH, JAMBA_ARCH):
        consistency_of(dev, get_config(arch, smoke=True).replace(
            dtype="float32", capacity_factor=16.0),
            "the smoke config, float32, capacity_factor 16")
    for arch, cuts in ((VLM_ARCH, {"n_layers": 2}),
                       (AUDIO_ARCH, {"n_layers": 2, "encoder_layers": 2})):
        full = get_config(arch)
        consistency_of(dev, full.replace(dtype="float32", **cuts), ", ".join(
            f"{k} {v} of {getattr(full, k)}" for k, v in cuts.items())
            + ", float32")
        free_card()


@torch.no_grad()
def consistency_of(dev, cfg, cut):
    """The vlm prompt follows its patches (logits compared at the token
    positions); the audio decoder reads CHECK_FRAMES frames."""
    kv = cfg.kv_cache_dtype
    model = build_model(cfg, dev)
    params = model.init_params(seed=1)
    rng = np.random.default_rng(3)
    n = CHECK_PROMPT + CHECK_STEPS
    toks = torch.from_numpy(rng.integers(0, cfg.vocab_size, (2, n)).astype(
        np.int32)).to(dev)
    extra, off = {}, 0
    if cfg.family == "vlm":
        off = cfg.vision_patches
        extra["patches"] = torch.from_numpy(rng.standard_normal(
            (2, off, cfg.d_model)).astype(np.float32)).to(dev)
    elif cfg.family == "audio":
        extra["frames"] = torch.from_numpy(rng.standard_normal(
            (2, CHECK_FRAMES, cfg.d_model)).astype(np.float32)).to(dev)
    full, _ = model.apply(params, {"tokens": toks, **extra})
    full = full[:, off:]
    last, cache = make_prefill_step(model)(
        params, {"tokens": toks[:, :CHECK_PROMPT], **extra})
    cache = pad_kv(cache, off + n)
    errs = [float((last - full[:, CHECK_PROMPT - 1]).abs().max())]
    ok = torch.allclose(last, full[:, CHECK_PROMPT - 1], atol=5e-4,
                        rtol=5e-4)
    for t in range(CHECK_PROMPT, n):
        logits, cache = model.apply(params, {"tokens": toks[:, t:t + 1]},
                                    mode="decode", cache=cache)
        errs.append(float((logits[:, 0] - full[:, t]).abs().max()))
        ok = ok and (kv == "int8" or torch.allclose(
            logits[:, 0], full[:, t], atol=5e-4, rtol=5e-4))
    rel = max(errs) / float(full.std())
    log({"phase": "consistency", "arch": cfg.name, "cut": cut,
         **({k: list(v.shape) for k, v in extra.items()}),
         "kv_cache_dtype": kv or cfg.dtype,
         "allow_tf32_matmul": torch.backends.cuda.matmul.allow_tf32,
         "allow_tf32_cudnn": torch.backends.cudnn.allow_tf32,
         "prompt": CHECK_PROMPT, "decode_steps": CHECK_STEPS,
         "max_abs_err": max(errs), "logit_max_abs":
         float(full.abs().max()), "relative_err": rel,
         "tolerance": "0.15 relative" if kv else 5e-4})
    if not ok or (kv == "int8" and not rel < 0.15):
        raise AssertionError(f"consistency ({cfg.name}, KV {kv or 'float'}):"
                             f" decode logits off the train-mode forward")


# ----------------------------------------------------------------------
# the dense family: serving and training
# ----------------------------------------------------------------------
@torch.no_grad()
def generate_in_slots(model, params, prompt, n_new, slots, max_seq,
                      extra=None):
    """Greedy tokens of ``prompt`` alone: one prefill of the prompt (with
    its ``extra`` batch entries, patches or frames), then decode steps of
    ``slots`` rows that each hold a copy of it (the serve loop's decode
    shapes); row 0's tokens."""
    logits, one = make_prefill_step(model)(
        params, {"tokens": prompt[None], **(extra or {})})
    one = pad_kv(one, max_seq)
    cache = {"blocks": [{k: v.expand(slots, *v.shape[1:]).contiguous()
                         for k, v in blk.items()} for blk in one["blocks"]],
             "index": one["index"].expand(slots).contiguous()}
    tok = torch.argmax(logits, dim=-1).to(torch.int32)[:, None]
    tok = tok.expand(slots, 1).contiguous()
    decode = make_decode_step(model)
    out = [tok]
    for _ in range(n_new - 1):
        tok, cache = decode(params, tok, cache)
        out.append(tok)
    return torch.cat(out, dim=1)[0].tolist()


def train_child(dev) -> int:
    """Phase 15a, in a child process whose environment sets
    ``CUBLAS_WORKSPACE_CONFIG``: smollm-360m at full width and depth in
    float32 trains TRAIN_STEPS steps of the copy task (batch TRAIN_BATCH
    x TRAIN_SEQ, ``remat="full"``) under deterministic algorithms, saving
    at RESTART_AT; then restores that checkpoint and runs the last steps
    again, which must give the same parameters and optimizer state bit
    for bit.  This fresh process also times the scan kernel at phase
    15b's training shape and at phase 5e's Jamba prefill shape, and the
    backward kernel at phase 15b's training shape and at phase 16's
    Jamba shape, with the profiler, which in the smoke's own process
    misses some of their launches (readings under the bound).  Prints
    JSON lines, the last one its result."""
    torch.use_deterministic_algorithms(True)
    scan_device_ms, bwd_device_ms = {}, {}
    jamba = get_config(JAMBA_ARCH)
    train_shape = (MAMBA_TRAIN_BT, MAMBA_TRAIN_L,
                   get_config(MAMBA_ARCH).d_inner,
                   get_config(MAMBA_ARCH).ssm_state)
    for path, shape in (
            ("train", train_shape),
            ("jamba_serve", (1, max(JAMBA_PROMPTS), jamba.d_inner,
                             jamba.ssm_state))):
        scan_args = scan_case(np.random.default_rng(6), dev, *shape,
                              torch.bfloat16)
        scan_device_ms[path] = device_ms(
            lambda: k_scan.selective_scan(*scan_args), 20)[0]
        del scan_args
    for path, shape, dtype in (("train", train_shape, torch.bfloat16),
                               ("jamba_train", JAMBA_TRAIN_SCAN,
                                torch.float32)):
        args = bwd_case(np.random.default_rng(6), dev, *shape, dtype)
        bwd_device_ms[path] = device_ms(
            lambda: k_scan.selective_scan_bwd(*args), 20)[0]
        del args
    cfg = get_config(DENSE_ARCH).replace(dtype="float32")
    model = build_model(cfg, dev)
    params = model.init_params(seed=0)
    ocfg = AdamWConfig(lr=3e-4, warmup_steps=5, total_steps=TRAIN_STEPS)
    opt = adamw_init(params, ocfg)
    step = make_train_step(model, ocfg, TrainStepConfig(remat="full"))
    batch = lambda i: copy_task_batch(cfg, TRAIN_BATCH, TRAIN_SEQ, i,
                                      device=dev)
    torch.cuda.synchronize()
    torch.cuda.reset_peak_memory_stats()
    losses, secs = [], []
    with tempfile.TemporaryDirectory() as td:
        ck = Checkpointer(td, keep=1)
        for i in range(TRAIN_STEPS):
            t0 = time.perf_counter()
            params, opt, met = step(params, opt, batch(i))
            losses.append(float(met["loss"]))          # synchronises
            secs.append(time.perf_counter() - t0)
            if i + 1 == RESTART_AT:
                t0 = time.perf_counter()
                ck.save(RESTART_AT, {"params": params, "opt": opt})
                save_s = time.perf_counter() - t0
        peak = torch.cuda.max_memory_allocated() / 1e9
        final = [p.detach().clone() for p in params.parameters()]
        final_opt = (opt.step.clone(), {k: v.clone() for k, v in
                                        opt.m.items()},
                     {k: v.clone() for k, v in opt.v.items()})
        t0 = time.perf_counter()
        restored, mani = ck.restore({"params": params, "opt": opt})
        restore_s = time.perf_counter() - t0
        params, opt = restored["params"], restored["opt"]
        for i in range(mani["step"], TRAIN_STEPS):
            params, opt, _ = step(params, opt, batch(i))
    same = all(torch.equal(a, b) for a, b in zip(params.parameters(),
                                                 final))
    same_opt = bool(torch.equal(opt.step, final_opt[0])) and all(
        torch.equal(opt.m[k], final_opt[1][k])
        and torch.equal(opt.v[k], final_opt[2][k]) for k in opt.m)
    warm = statistics.median(secs[1:])
    state_gb = sum(p.numel() for p in params.parameters()) * 4 * 4 / 1e9
    print(json.dumps({
        "phase": "train_dense", "arch": cfg.name, "dtype": cfg.dtype,
        "n_layers": cfg.n_layers, "batch": TRAIN_BATCH, "seq": TRAIN_SEQ,
        "remat": "full", "steps": TRAIN_STEPS, "deterministic": True,
        "params": sum(p.numel() for p in params.parameters()),
        "params_grads_adamw_gb": state_gb, "first_step_s": secs[0],
        "step_s": warm, "tokens_per_s": TRAIN_BATCH * TRAIN_SEQ / warm,
        "peak_memory_gb": peak, "losses_first5": losses[:5],
        "losses_last5": losses[-5:], "save_snapshot_s": save_s,
        "restore_s": restore_s, "restart_at": RESTART_AT,
        "restart_bitwise_equal": same, "restart_opt_bitwise_equal":
        same_opt, "scan_device_ms": scan_device_ms,
        "scan_bwd_device_ms": bwd_device_ms}),
        flush=True)
    return 0


def train_dense_child():
    """Phase 15a through a child process (see ``train_child``)."""
    env = dict(os.environ, CUBLAS_WORKSPACE_CONFIG=":4096:8")
    out = subprocess.run([sys.executable, os.path.abspath(__file__),
                          TRAIN_CHILD_FLAG], env=env, capture_output=True,
                         text=True, timeout=600)
    lines = out.stdout.strip().splitlines()
    if out.returncode != 0 or not lines:
        raise AssertionError(f"train_dense: child exited {out.returncode}: "
                             f"{out.stderr[-3000:]}")
    res = json.loads(lines[-1])
    log(res)
    first, last = res["losses_first5"], res["losses_last5"]
    if not all(np.isfinite(first + last)) or not (
            statistics.mean(last) < statistics.mean(first)):
        raise AssertionError(f"train_dense: losses {first} -> {last}")
    if not (res["restart_bitwise_equal"] and res["restart_opt_bitwise_equal"]):
        raise AssertionError("train_dense: the restarted run differs from "
                             "the uninterrupted one")
    return res["scan_device_ms"], res["scan_bwd_device_ms"]


class BwdTimer:
    """Times the scan's backward (the backward kernel and its wrapper)
    between two synchronises, by wrapping ``_ScanWithKernelGrad.backward``
    for as long as it is open."""

    def __init__(self) -> None:
        self.cls = k_scan._ScanWithKernelGrad
        self.orig = self.cls.backward
        self.secs, self.calls = 0.0, 0
        timer = self

        def backward(ctx, *grads):
            torch.cuda.synchronize()
            t0 = time.perf_counter()
            out = timer.orig(ctx, *grads)
            torch.cuda.synchronize()
            timer.secs += time.perf_counter() - t0
            timer.calls += 1
            return out
        self.cls.backward = staticmethod(backward)

    def close(self) -> None:
        self.cls.backward = staticmethod(self.orig)


def train_mamba(dev, scan_ms, bwd_ms):
    """Phase 15b: falcon-mamba-7b at full width cut to MAMBA_TRAIN_LAYERS
    layers (64 would need ~84 GB: bf16 weights and grads plus float32
    AdamW state), bf16, Bt MAMBA_TRAIN_BT x L MAMBA_TRAIN_L: steps with
    ``remat="full"`` (one micro-batch) and ``"none"`` (two), each with
    exactly layers x (2 or 1) x micro-batches ``selective_scan`` and
    layers x micro-batches ``selective_scan_bwd`` CUDA launches; step
    time, tokens/s and peak memory.  Then one more ``"full"`` step with
    the scan's backward timed between synchronises: its share of a step,
    and the two kernels' from ``scan_ms`` and ``bwd_ms``, their device
    time per launch at this shape (the profiler, in phase 15a's fresh
    process).  Returns the CUDA launches of the counted steps and the
    scan's largest training inputs."""
    t_phase = time.perf_counter()
    cfg = get_config(MAMBA_ARCH).replace(n_layers=MAMBA_TRAIN_LAYERS)
    model = build_model(cfg, dev)
    params = model.init_params(seed=0)
    ocfg = AdamWConfig()
    opt = adamw_init(params, ocfg)
    n_params = sum(p.numel() for p in params.parameters())
    batch = lambda i: copy_task_batch(cfg, MAMBA_TRAIN_BT, MAMBA_TRAIN_L, i,
                                      device=dev)
    steps = {remat: make_train_step(model, ocfg, TrainStepConfig(
        microbatches=mb, remat=remat)) for remat, mb in MAMBA_TRAIN_RUNS}
    torch.cuda.synchronize()
    torch.cuda.reset_peak_memory_stats()
    tap = ScanTap()
    total, i, per_step = {}, 0, {}
    for remat, mb in MAMBA_TRAIN_RUNS:
        secs = []
        for _ in range(MAMBA_TRAIN_STEPS[remat]):
            counters.reset_device_launches()
            t0 = time.perf_counter()
            params, opt, met = steps[remat](params, opt, batch(i))
            loss = float(met["loss"])                     # synchronises
            secs.append(time.perf_counter() - t0)
            got = counters.device_launch_stats()
            want = {"selective_scan": cfg.n_layers * mb
                    * (2 if remat == "full" else 1),
                    "selective_scan_bwd": cfg.n_layers * mb}
            if got != want or not np.isfinite(loss):
                raise AssertionError(f"train_mamba ({remat}, {mb} "
                                     f"micro-batches): CUDA launches {got}, "
                                     f"expected {want}; loss {loss}")
            for k, v in got.items():
                total[k] = total.get(k, 0) + v
            i += 1
        per_step[remat] = want
        step_s = statistics.median(secs)
        log({"phase": "train_mamba", "arch": cfg.name, "dtype": cfg.dtype,
             "n_layers": cfg.n_layers, "cut": f"n_layers {cfg.n_layers} of "
             f"{get_config(MAMBA_ARCH).n_layers}", "params": n_params,
             "batch": MAMBA_TRAIN_BT, "seq": MAMBA_TRAIN_L, "remat": remat,
             "microbatches": mb, "steps": len(secs), "step_s": step_s,
             "steps_s": secs,
             "tokens_per_s": MAMBA_TRAIN_BT * MAMBA_TRAIN_L / step_s,
             "launches_per_step": want, "loss": loss})
    tap.close()
    log({"phase": "train_mamba", "peak_memory_gb":
         torch.cuda.max_memory_allocated() / 1e9,
         "selective_scan_cuda_launches": total})

    largest = tuple(a.detach() for a in tap.largest)
    bwd = BwdTimer()
    try:
        t0 = time.perf_counter()
        params, opt, met = steps["full"](params, opt, batch(i))
        torch.cuda.synchronize()
        timed_wall = time.perf_counter() - t0
    finally:
        bwd.close()
    full = per_step["full"]
    log({"phase": "train_mamba_profile", "remat": "full",
         "bwd_timed_step_s": timed_wall, "bwd_calls": bwd.calls,
         "bwd_s": bwd.secs, "bwd_share": bwd.secs / timed_wall,
         "scan_kernel_device_ms": scan_ms,
         "scan_kernel_share": full["selective_scan"] * scan_ms * 1e-3
         / timed_wall,
         "bwd_kernel_device_ms": bwd_ms,
         "bwd_kernel_share": full["selective_scan_bwd"] * bwd_ms * 1e-3
         / timed_wall, "wall_s": time.perf_counter() - t_phase})
    if bwd.calls != cfg.n_layers:
        raise AssertionError(f"train_mamba: {bwd.calls} scan backward "
                             f"calls in a step, expected {cfg.n_layers}")
    return total, largest


def train_consistency(dev):
    """Phase 16: one train step (2 micro-batches, batch 2 x 64, float32,
    TF32 off) of falcon-mamba-7b and smollm-360m at full width cut to 2
    layers, and of the qwen3-moe (2 layers) and Jamba (8 layers) smoke
    configs, on the card against the port on the CPU, from the same
    parameters (drawn on the CPU, copied) and data: loss within 1e-4,
    grads within 1e-3 of each leaf's max |g|, parameters after the step
    within 1e-4 (the reference's own bound, ``test_training.py``).  For
    the MoE layers, how many tokens' top-k sets agree between the two
    sides is logged, with the calls and tokens where they differ.  The
    card's step launches exactly Mamba layers x micro-batches x 2
    ``selective_scan`` (``remat="full"``) and Mamba layers x
    micro-batches ``selective_scan_bwd``, and nothing else.  Returns those
    launches by arch and the largest scan inputs of Jamba's card step."""
    torch.backends.cuda.matmul.allow_tf32 = False
    tcfg = TrainStepConfig(microbatches=CONSIST_MB)
    ocfg = AdamWConfig(lr=1e-3)
    cases = [(get_config(arch).replace(n_layers=2, dtype="float32"),
              "n_layers 2, float32") for arch in (MAMBA_ARCH, DENSE_ARCH)]
    cases += [(get_config(arch, smoke=True).replace(dtype="float32"),
               f"the smoke config ({get_config(arch, smoke=True).n_layers} "
               f"layers), float32")
              for arch in (MOE_ARCH, JAMBA_ARCH, VLM_ARCH, AUDIO_ARCH)]
    shape = ShapeSpec("t", CONSIST_SEQ, CONSIST_BATCH, "train")
    launches, jamba_inputs = {}, None
    for cfg, cut in cases:
        sides = []
        n_mamba = sum(cfg.layer_kind(i) == "mamba"
                      for i in range(cfg.n_layers))
        want = {"selective_scan": n_mamba * CONSIST_MB * 2,
                "selective_scan_bwd": n_mamba * CONSIST_MB} if n_mamba \
            else {}
        for side in ("cpu", dev):
            model = build_model(cfg, side)
            if side == "cpu":
                params = model.init_params(seed=0)
                start = copy.deepcopy(params)
            else:
                params = start.to(dev)
            batch = make_batch_for(cfg, shape, 0, task="copy", device=side)
            routes, scans = RouteTap(), ScanTap()
            counters.reset_device_launches()
            try:
                grads, loss = make_grad_fn(model, tcfg)(params, batch)
            finally:
                routes.close()
                scans.close()
            if side != "cpu":
                got = counters.device_launch_stats()
                if got != want:
                    raise AssertionError(f"train_consistency ({cfg.name}): "
                                         f"CUDA launches {got}, expected "
                                         f"{want}")
                launches[cfg.name] = got
                if cfg.family == "hybrid":                  # Jamba
                    jamba_inputs = tuple(a.detach() for a in scans.largest)
            params, _, _ = adamw_update(grads, adamw_init(params, ocfg),
                                        params, ocfg)
            sides.append((float(loss), {k: g.cpu() for k, g in
                                        grads.items()},
                          {k: p.detach().cpu() for k, p in
                           params.named_parameters()},
                          [t.sort(dim=-1).values.cpu()
                           for t in routes.take()]))
        (loss, grads, new, sets), (dloss, dgrads, dnew, dsets) = sides
        routing = {}
        if sets:
            agree = [(a == b).all(-1) for a, b in zip(sets, dsets)]
            routing = {"topk_sets_agree": int(sum(a.sum() for a in agree)),
                       "topk_sets": int(sum(a.numel() for a in agree)),
                       "routings": len(sets), "disagree_at": {
                           i: (~a).nonzero().tolist()[:8]
                           for i, a in enumerate(agree) if not a.all()}}
        grad_rel = {k: float((dgrads[k] - g).abs().max())
                    / max(float(g.abs().max()), 1e-30)
                    for k, g in grads.items()}
        param_err = {k: float((dnew[k] - p).abs().max())
                     for k, p in new.items()}
        bad = sorted([k for k, v in grad_rel.items() if v > 1e-3]
                     + [k for k, v in param_err.items() if v > 1e-4])
        log({"phase": "train_consistency", "arch": cfg.name,
             "cut": f"{cut}, batch 2 x 64, 2 micro-batches", **routing,
             "batch": {k: list(v.shape) for k, v in batch.items()},
             "loss_cpu": loss, "loss_card": dloss,
             "loss_abs_err": abs(loss - dloss),
             "max_grad_err_of_leaf_max": max(grad_rel.values()),
             "worst_grad_leaf": max(grad_rel, key=grad_rel.get),
             "max_param_abs_err": max(param_err.values()),
             "leaves": len(grads), "leaves_off_bound": bad,
             "cuda_launches": want})
        if abs(loss - dloss) > 1e-4 or bad:
            raise AssertionError(f"train_consistency ({cfg.name}): loss "
                                 f"{loss} vs {dloss}; leaves off their "
                                 f"bound: {bad}")
    return launches, jamba_inputs


# ----------------------------------------------------------------------
# the moe and hybrid families: serving and training
# ----------------------------------------------------------------------
class RouteTap:
    """Wraps ``moe.route``: keeps each call's expert ids (``[G, Tg, k]``,
    on their device) for the capacity and agreement checks; launches
    nothing itself."""

    def __init__(self) -> None:
        self.orig, self.calls = moe.route, []
        moe.route = self._observed

    def _observed(self, *args):
        top_p, top_i = self.orig(*args)
        self.calls.append(top_i.detach())
        return top_p, top_i

    def take(self):
        calls, self.calls = self.calls, []
        return calls

    def close(self) -> None:
        moe.route = self.orig


def dropped_slots(top_i, cfg) -> int:
    """Slots of one ``moe.route`` call past their expert's capacity: each
    group of ``Tg`` tokens keeps at most ``capacity_for(Tg)`` slots an
    expert (the rest go to the trash index)."""
    g, tg, k = top_i.shape
    cap = moe.capacity_for(tg, k, cfg.n_experts, cfg.capacity_factor)
    ids = top_i.reshape(g, -1)
    counts = torch.zeros((g, cfg.n_experts), dtype=torch.int64,
                         device=ids.device).scatter_add_(
                             1, ids, torch.ones_like(ids))
    return int((counts - cap).clamp(min=0).sum())


def routing_of(cfg, tokens) -> dict:
    """The routing group and capacity of one MoE call on ``tokens``."""
    tg = moe.group_size_for(tokens, cfg.moe_group_size)
    return {"tokens": tokens, "group": tg, "groups": tokens // tg,
            "cap": moe.capacity_for(tg, cfg.experts_per_token,
                                    cfg.n_experts, cfg.capacity_factor)}


def free_card() -> dict:
    """Hands what earlier phases left in the allocator's cache back to
    the card; the card's free and total memory after, and what is still
    allocated, in GB."""
    gc.collect()
    torch.cuda.synchronize()
    torch.cuda.empty_cache()
    free, total = torch.cuda.mem_get_info()
    return {"free_gb": free / 1e9, "total_gb": total / 1e9,
            "allocated_gb": torch.cuda.memory_allocated() / 1e9}


class EncodeTimer:
    """Wraps an ``EncDec``'s ``encode``: host seconds of each call between
    two synchronises (the encoder's share of an audio prefill)."""

    def __init__(self, params) -> None:
        self.params, self.orig, self.secs = params, params.encode, []
        params.encode = self._timed

    def _timed(self, *args, **kw):
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        out = self.orig(*args, **kw)
        torch.cuda.synchronize()
        self.secs.append(time.perf_counter() - t0)
        return out

    def close(self) -> None:
        del self.params.encode


def serve_routed(dev, label, arch, cuts, prompts, n_new, max_seq=None,
                 frames=None):
    """Phases 5b-5g: ``arch`` at full width (bf16, random weights from a
    seeded generator on the card, ``cuts`` logged) serves one request
    per entry of ``prompts`` through ``launch/serve.py``'s loop with
    SERVE_SLOTS slots, ``n_new`` tokens each, each prompt prefilled
    alone, with its own patches (vlm) or ``frames`` frames (audio) drawn
    by the launcher's ``request_inputs``.  Each request's tokens must
    equal greedy generation of its inputs alone at the loop's batch
    (``generate_in_slots``: bf16 products at 1 and 4 rows round apart);
    for one request of each prompt length, the first difference from
    ``greedy_generate`` at batch 1 is logged.  With MoE layers, decode
    rows are independent
    only while an expert's capacity holds a whole step (one group of
    SERVE_SLOTS tokens), so the check also counts the slots dropped by
    capacity: logged per prefill, and none allowed in a decode step.
    ``max_seq`` defaults to the patches, the longest prompt and
    ``n_new``.  Logs the decode bound: the weights a step reads (all but
    an untied embedding table, of which it gathers rows, and an encoder,
    whose output the cache holds) and the whole cache, at the HBM rate.  Returns the CUDA launches of the counted run
    and the scan's largest inputs (None without Mamba layers)."""
    full = get_config(arch)
    cfg = full.replace(**cuts)
    audio = cfg.family == "audio"
    patches = cfg.vision_patches if cfg.family == "vlm" else 0
    max_seq = max_seq or patches + max(prompts) + n_new
    log({"phase": label, "arch": cfg.name,
         "memory_before_init": free_card()})
    torch.cuda.reset_peak_memory_stats()
    model = build_model(cfg, dev)
    t0 = time.perf_counter()
    params = model.init_params(seed=0)
    torch.cuda.synchronize()
    kinds = [(cfg.layer_kind(i), cfg.ffn_kind(i))
             for i in range(cfg.n_layers)]
    kv_bytes = (2 * sum(k == "attn" for k, _ in kinds) * SERVE_SLOTS
                * (max_seq + (frames if audio else 0)) * cfg.n_kv_heads
                * cfg.hd * 2)
    weights = sum(p.numel() * p.element_size() for p in params.parameters())
    read = sum(p.numel() * p.element_size()
               for n, p in params.named_parameters()
               if not (n.startswith(("enc_blocks.", "enc_final_norm"))
                       or n == "embed" and not cfg.tie_embeddings))
    log({"phase": label, "arch": cfg.name, "family": cfg.family,
         "n_layers": cfg.n_layers, "d_model": cfg.d_model,
         "heads": [cfg.n_heads, cfg.n_kv_heads], "head_dim": cfg.hd,
         "vocab": cfg.vocab_size, "experts": cfg.n_experts, "top_k": cfg.experts_per_token,
         "moe_d_ff": cfg.moe_d_ff, "shared_expert": cfg.shared_expert,
         "layers": ["/".join(k) for k in kinds], "dtype": cfg.dtype,
         "cut": {k: f"{v} of {getattr(full, k)}" for k, v in cuts.items()}
         or "none (full size)",
         "params": sum(p.numel() for p in params.parameters()),
         "weights_gb": weights / 1e9, "init_s": time.perf_counter() - t0,
         **({"vision_patches": patches} if patches else {}),
         **({"encoder_layers": cfg.encoder_layers, "frames": frames}
            if audio else {}),
         "decode_bound_ms": 1e3 * (read + kv_bytes) / HBM_BYTES_PER_S,
         "init_largest_float32_draw_gb": 4 * min(
             max(p.numel() for p in params.parameters()),
             model_params.DRAW_ELEMENTS) / 1e9,
         "memory_after_init": free_card(), "max_seq": max_seq,
         "kv_cache_gb": kv_bytes / 1e9,
         **({"routing_prefill": [routing_of(cfg, n)
                                 for n in sorted(set(prompts))],
             "routing_decode": routing_of(cfg, SERVE_SLOTS)}
            if cfg.n_experts else {})})
    rng = np.random.default_rng(5)
    rb, inputs = RequestBatcher(SERVE_SLOTS), {}
    for i, length in enumerate(prompts):
        rid = f"{length}-{i}"
        rb.submit(Request(id=rid, max_new_tokens=n_new,
                          prompt=rng.integers(0, cfg.vocab_size,
                                              length).tolist()))
        inputs[rid] = {k: v.to(dev) for k, v in request_inputs(
            cfg, length, frames, i).items()}
    warm = RequestBatcher(SERVE_SLOTS)          # cuBLAS and the allocator
    warm.submit(Request(id="warm", prompt=[1] * 8, max_new_tokens=2))
    serve_requests(model, params, warm, max_seq,
                   {"warm": request_inputs(cfg, 8, frames, len(prompts))})

    timer, scans = ApplyTap(model, timed=True), ScanTap()
    encoder = EncodeTimer(params) if audio else None
    counters.reset_device_launches()
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    n_tok, steps = serve_requests(model, params, rb, max_seq, inputs)
    torch.cuda.synchronize()
    wall = time.perf_counter() - t0
    launches = counters.device_launch_stats()
    scans.close()
    timer.close(label)
    if encoder is not None:
        encoder.close()
    done = rb.completed
    if len(done) != len(prompts) or n_tok != len(done) * n_new or any(
            len(r.generated) != n_new for r in done):
        raise AssertionError(f"{label}: not every request was served")
    mamba_layers = sum(k == "mamba" for k, _ in kinds)
    want = {"selective_scan": mamba_layers * len(done)} if mamba_layers \
        else {}
    if timer.calls["prefill"] != len(done) or launches != want:
        raise AssertionError(f"{label}: {timer.calls['prefill']} prefills, "
                             f"CUDA launches {launches}, expected {want}")
    log({"phase": label, "requests": len(done), "wall_s": wall,
         "generated_tokens": n_tok, "decode_steps": steps,
         "prefills": timer.calls["prefill"],
         "prefill_s": timer.secs["prefill"],
         "prefill_tokens_per_s": sum(prompts) / timer.secs["prefill"],
         **({"prefill_positions_per_s": (sum(prompts) + patches
                                         * len(prompts))
             / timer.secs["prefill"]} if patches else {}),
         **({"encoder_ms_per_request": 1e3 * statistics.mean(encoder.secs),
             "encoder_calls": len(encoder.secs),
             "encoder_frames_per_s": frames * len(encoder.secs)
             / sum(encoder.secs)} if audio else {}),
         "decode_s": timer.secs["decode"],
         "decode_tokens_per_s": (n_tok - len(done)) / timer.secs["decode"],
         "decode_step_ms": 1e3 * timer.secs["decode"] / steps,
         "tokens_per_s": n_tok / wall,
         "peak_memory_gb": torch.cuda.max_memory_allocated() / 1e9,
         "cuda_launches": launches,
         "selective_scan_per_prefill":
         launches.get("selective_scan", 0) / len(done)})

    # each request alone at the loop's shapes, counting the slots its
    # prefill and decode steps drop; then, logged, greedy_generate at
    # batch 1 for the first request of each prompt length
    routes = RouteTap()
    n_moe = sum(f == "moe" for _, f in kinds)
    differ, batch1_first, drops, by_layer = [], {}, {}, {}
    batch1_lengths = set()
    try:
        for r in done:
            prompt = torch.tensor(r.prompt, dtype=torch.int32, device=dev)
            if generate_in_slots(model, params, prompt, n_new, SERVE_SLOTS,
                                 max_seq, inputs[r.id]) != r.generated:
                differ.append(r.id)
            calls = routes.take()
            by_layer[r.id] = [dropped_slots(t, cfg) for t in calls[:n_moe]]
            drops[r.id] = sum(by_layer[r.id])
            late = sum(dropped_slots(t, cfg) for t in calls[n_moe:])
            if len(calls) != n_moe * n_new or late:
                raise AssertionError(f"{label}: {len(calls)} routings, "
                                     f"{late} slots dropped in decode steps")
            if len(r.prompt) in batch1_lengths:
                continue
            batch1_lengths.add(len(r.prompt))
            alone = greedy_generate(model, params, {
                "tokens": prompt[None], **inputs[r.id]}, n_new,
                max_seq=max_seq)
            routes.take()
            batch1_first[r.id] = next((k for k, (a, b) in enumerate(zip(
                alone[0].tolist(), r.generated)) if a != b), None)
    finally:
        routes.close()
    log({"phase": label, "check": "each request's tokens equal greedy "
         "generation of its prompt alone at the loop's batch",
         "differ": differ, **({
             "dropped_slots_per_prefill": drops,
             "slots_per_prefill": {r.id: n_moe * len(r.prompt)
                                   * cfg.experts_per_token for r in done},
             "dropped_slots_by_moe_layer": {
                 done[-1].id: by_layer[done[-1].id]},
             "dropped_slots_in_decode_steps": 0} if n_moe else {}),
         "batch1_compared": len(batch1_first),
         "batch1_equal": sum(v is None for v in batch1_first.values()),
         "batch1_first_difference": {k: v for k, v in batch1_first.items()
                                     if v is not None}})
    if differ:
        raise AssertionError(f"{label}: requests {differ} differ from greedy "
                             f"generation of their prompts alone")
    largest = None
    if scans.largest is not None:
        largest = tuple(a.detach().clone() for a in scans.largest)
    return launches, largest


def serve_moe_and_hybrid(dev):
    """Phases 5c-5e.  Returns Jamba's ``selective_scan`` launches and the
    largest inputs its prefills gave the scan (Bt 1 x L 1024 x Di 16384
    x S 16), for phase 6b."""
    serve_routed(dev, "moe_serve", MOE_ARCH, {}, SERVE_TRAFFIC,
                 SERVE_NEW_TOKENS)
    serve_routed(dev, "maverick_serve", MAVERICK_ARCH, MAVERICK_CUTS,
                 MAVERICK_PROMPTS, MAVERICK_NEW_TOKENS)
    launches, inputs = serve_routed(dev, "jamba_serve", JAMBA_ARCH,
                                    JAMBA_CUTS, JAMBA_PROMPTS,
                                    JAMBA_NEW_TOKENS)
    free_card()
    return launches["selective_scan"], inputs


def serve_vlm_and_audio(dev):
    """Phases 5f-5g: internvl2-76b at full width, 8 layers, each request
    with its 256 patches; whisper-medium at full size, each request with
    AUDIO_FRAMES frames through the encoder.  Neither launches a kernel
    of the port (``serve_routed`` holds the counts to none)."""
    serve_routed(dev, "vlm_serve", VLM_ARCH, VLM_CUTS, VLM_PROMPTS,
                 VLM_NEW_TOKENS, max_seq=VLM_MAX_SEQ)
    serve_routed(dev, "audio_serve", AUDIO_ARCH, {}, AUDIO_PROMPTS,
                 AUDIO_NEW_TOKENS, max_seq=AUDIO_MAX_SEQ,
                 frames=AUDIO_FRAMES)
    free_card()


def train_audio(dev):
    """Phase 15d: whisper-medium at full size, bf16, AUDIO_TRAIN_STEPS
    steps of the copy task at ``make_batch_for``'s audio shapes for
    AUDIO_TRAIN_SHAPE (frames [8, 1024, 1024], decoder tokens [8, 128])
    with ``remat="full"``: finite losses that fall; step time, frames and
    tokens a second, and peak memory beside the memory reckoned before
    the run (bf16 parameters and grads, the float32 AdamW state and its
    new copy, bf16 and float32 logits, each layer's saved input)."""
    cfg = get_config(AUDIO_ARCH)
    n = cfg.param_count()
    b, f = AUDIO_TRAIN_SHAPE.global_batch, AUDIO_TRAIN_SHAPE.seq_len
    sd = max(f // 8, 8)
    reckon = {"params_gb": 2 * n / 1e9, "grads_gb": 2 * n / 1e9,
              "adamw_state_and_update_gb": 2 * 8 * n / 1e9,
              "logits_gb": (2 + 4) * b * sd * cfg.vocab_size / 1e9,
              "layer_inputs_gb": 2 * cfg.d_model * b * (
                  f * cfg.encoder_layers + sd * cfg.n_layers) / 1e9}
    reckon["total_gb"] = sum(reckon.values())
    log({"phase": "train_audio", "arch": cfg.name,
         "memory_before_init": free_card(), "reckoned": reckon})
    model = build_model(cfg, dev)
    params = model.init_params(seed=0)
    ocfg = AdamWConfig(lr=1e-3, warmup_steps=2,
                       total_steps=AUDIO_TRAIN_STEPS)
    opt = adamw_init(params, ocfg)
    step = make_train_step(model, ocfg, TrainStepConfig(remat="full"))
    torch.cuda.synchronize()
    torch.cuda.reset_peak_memory_stats()
    losses, secs = [], []
    for i in range(AUDIO_TRAIN_STEPS):
        batch = make_batch_for(cfg, AUDIO_TRAIN_SHAPE, i, task="copy",
                               device=dev)
        t0 = time.perf_counter()
        params, opt, met = step(params, opt, batch)
        losses.append(float(met["loss"]))               # synchronises
        secs.append(time.perf_counter() - t0)
    warm = statistics.median(secs[1:])
    log({"phase": "train_audio", "arch": cfg.name, "dtype": cfg.dtype,
         "layers": [cfg.encoder_layers, cfg.n_layers], "cut": "none",
         "params": sum(p.numel() for p in params.parameters()),
         "frames": [b, f, cfg.d_model], "tokens": [b, sd], "remat": "full",
         "steps": AUDIO_TRAIN_STEPS, "first_step_s": secs[0],
         "step_s": warm, "frames_per_s": b * f / warm,
         "tokens_per_s": b * sd / warm,
         "peak_memory_gb": torch.cuda.max_memory_allocated() / 1e9,
         "losses": losses})
    half = AUDIO_TRAIN_STEPS // 2
    if not all(np.isfinite(losses)) or not (
            statistics.mean(losses[half:]) < statistics.mean(losses[:half])):
        raise AssertionError(f"train_audio: losses {losses}")


def train_moe(dev):
    """Phase 15c: qwen3-moe-30b-a3b at full width cut to MOE_TRAIN_LAYERS
    layers, bf16, MOE_TRAIN_STEPS steps of the copy task at batch
    MOE_TRAIN_BATCH x MOE_TRAIN_SEQ with ``remat="full"``: finite losses
    that fall; step time, tokens/s and peak memory, beside the memory
    reckoned before the run (bf16 parameters and grads, float32 AdamW
    state as in phase 15b, bf16 and float32 logits)."""
    full = get_config(MOE_ARCH)
    cfg = full.replace(n_layers=MOE_TRAIN_LAYERS)
    n = cfg.param_count()
    logits = MOE_TRAIN_BATCH * MOE_TRAIN_SEQ * cfg.vocab_size
    reckon = {"params_gb": 2 * n / 1e9, "grads_gb": 2 * n / 1e9,
              "adamw_state_gb": 8 * n / 1e9,
              "logits_gb": (2 + 4) * logits / 1e9}
    reckon["total_gb"] = sum(reckon.values())
    log({"phase": "train_moe", "arch": cfg.name,
         "memory_before_init": free_card(), "reckoned": reckon})
    model = build_model(cfg, dev)
    params = model.init_params(seed=0)
    ocfg = AdamWConfig(lr=1e-3, warmup_steps=2, total_steps=MOE_TRAIN_STEPS)
    opt = adamw_init(params, ocfg)
    step = make_train_step(model, ocfg, TrainStepConfig(remat="full"))
    torch.cuda.synchronize()
    torch.cuda.reset_peak_memory_stats()
    losses, secs = [], []
    for i in range(MOE_TRAIN_STEPS):
        batch = copy_task_batch(cfg, MOE_TRAIN_BATCH, MOE_TRAIN_SEQ, i,
                                device=dev)
        t0 = time.perf_counter()
        params, opt, met = step(params, opt, batch)
        losses.append(float(met["loss"]))               # synchronises
        secs.append(time.perf_counter() - t0)
    warm = statistics.median(secs[1:])
    log({"phase": "train_moe", "arch": cfg.name, "dtype": cfg.dtype,
         "n_layers": cfg.n_layers,
         "cut": f"n_layers {cfg.n_layers} of {full.n_layers}",
         "params": sum(p.numel() for p in params.parameters()),
         "batch": MOE_TRAIN_BATCH, "seq": MOE_TRAIN_SEQ, "remat": "full",
         "routing": routing_of(cfg, MOE_TRAIN_BATCH * MOE_TRAIN_SEQ),
         "steps": MOE_TRAIN_STEPS, "first_step_s": secs[0], "step_s": warm,
         "tokens_per_s": MOE_TRAIN_BATCH * MOE_TRAIN_SEQ / warm,
         "peak_memory_gb": torch.cuda.max_memory_allocated() / 1e9,
         "losses": losses})
    half = MOE_TRAIN_STEPS // 2
    if not all(np.isfinite(losses)) or not (
            statistics.mean(losses[half:]) < statistics.mean(losses[:half])):
        raise AssertionError(f"train_moe: losses {losses}")


# ----------------------------------------------------------------------
# the fleet: every event of a sim in one CUDA thread block
# ----------------------------------------------------------------------
def tag_of(sc, ac):
    return f"{SCHED_NAMES[sc]}-{ALLOC_NAMES[ac]}"


def policy_sims(base, seed=None, suffix=""):
    """The 8 Table-2 policies on one built state (the job rows do not
    depend on the policy)."""
    return [FleetSim(f"{tag_of(sc, ac)}{suffix}",
                     base.state._replace(sched_id=np.int32(sc),
                                         alloc_id=np.int32(ac)),
                     base.meta, sc, ac, seed)
            for sc, ac in POLICIES]


def batch_bytes(states):
    """Bytes of the stacked SimState of ``states``."""
    return sum(np.asarray(x).nbytes for st in states for x in st)


def check_invariants(res, i):
    """Every job COMPLETED or REJECTED, every node's availability back to
    its capacity, no start before its submission, and the counters and
    the event log adding up."""
    f, sim = res.finals[i], res.sims[i]
    live = np.zeros(f.submit.shape[0], dtype=bool)    # pad rows: False
    live[:len(sim.meta.ids)] = [jid is not None for jid in sim.meta.ids]
    st, start, submit = f.state[live], f.start[live], f.submit[live]
    n = int(live.sum())
    ev = int(f.n_events)
    failed = []
    if not np.isin(st, (COMPLETED, REJECTED)).all():
        failed.append("a job neither completed nor rejected")
    if not np.array_equal(f.avail, f.capacity):
        failed.append("final avail != capacity")
    ran = start != UNSET_I
    if (start[ran] < submit[ran]).any():
        failed.append("a start before its submission")
    if not (int(f.n_submitted) == n == int(f.n_completed)
            + int(f.n_rejected)):
        failed.append("submitted/completed/rejected do not add up")
    if int((st == COMPLETED).sum()) != int(f.n_completed):
        failed.append("completed count != COMPLETED rows")
    if int(f.log_started[:ev].sum()) != int(f.n_started) + int(
            f.n_requeued):
        failed.append("logged starts != starts")
    if ev > f.log_t.shape[0] or int(f.steps) != ev or (
            np.diff(f.log_t[:ev]) < 0).any():
        failed.append("event log out of order or overflowed")
    if failed:
        raise AssertionError(f"fleet {sim.name}: {'; '.join(failed)}")


def twin_trace(rec):
    """The job table a numpy twin's Recorder saw: {id: [start, nodes]}."""
    return {str(jid): [t, [int(x) for x in nodes]]
            for t, plan in rec.traces for jid, nodes in plan}


def check_against_twin(res, i, rec, summ, label):
    """Job by job (start, nodes, state) and the summary counters of a
    sim run to the end, against a numpy twin run to the end."""
    got = res.trace(i)
    want = {jid: v + ["COMPLETED"] for jid, v in twin_trace(rec).items()}
    for jid in got:
        want.setdefault(jid, [None, [], "REJECTED"])
    if set(want) != set(got):
        raise AssertionError(f"{label}: job ids differ from the twin")
    diff = [j for j in got if got[j] != want[j]]
    if diff:
        raise AssertionError(f"{label}: {len(diff)} jobs differ from the "
                             f"numpy twin, e.g. {diff[0]}: {got[diff[0]]} "
                             f"!= {want[diff[0]]}")
    fs = res.summary(i)
    for k in ("events", "submitted", "completed", "rejected",
              "sim_end_time"):
        if fs[k] != summ[k]:
            raise AssertionError(f"{label}: summary {k} {fs[k]} != "
                                 f"{summ[k]}")


def check_prefix(res, i, rec, label):
    """The first dispatch events of a sim against a twin cut there: per
    event the time, queue before and after, jobs started, and the start
    and nodes of every job started by then."""
    f = res.finals[i]
    ev = int(f.n_events)
    q0 = f.log_queue[:ev] + f.log_started[:ev]
    disp = np.flatnonzero(q0 > 0)[:len(rec.traces)]
    if len(disp) != len(rec.traces):
        raise AssertionError(f"{label}: fewer dispatch events than the twin")
    rows = {jid: r for r, jid in enumerate(res.sims[i].meta.ids)
            if jid is not None}
    for e, (t, plan), q in zip(disp, rec.traces, rec.queues):
        if (int(f.log_t[e]), int(q0[e]), int(f.log_started[e])) != (
                t, q, len(plan)):
            raise AssertionError(f"{label}: event {e} (t {t}) differs from "
                                 f"the numpy twin")
        for jid, nodes in plan:
            r = rows[str(jid)]
            if (int(f.start[r]), [int(x) for x in
                                  f.assigned[r, :len(nodes)]]) != (
                    t, [int(x) for x in nodes]):
                raise AssertionError(f"{label}: job {jid} differs from the "
                                     f"numpy twin")
    return len(disp)


def run_fleet(sims, profile=False):
    """One counted ``FleetRunner().run`` (on the card, every visible
    device); with ``profile``, under the profiler for the device time.
    Returns (result, host wall s, kernel device s, all device s)."""
    with (torch.profiler.profile(
            activities=[torch.profiler.ProfilerActivity.CUDA])
          if profile else contextlib.nullcontext()) as prof:
        t0 = time.perf_counter()
        res = FleetRunner().run(sims)
        torch.cuda.synchronize()
        wall = time.perf_counter() - t0
    ours = total = None
    if profile:
        ours, total = (x * 1e-6 for x in device_time_us(prof))
    return res, wall, ours, total


def launch_states(res, sims):
    """{cost class: the states of its launch, padded as the runner padded
    them, and their indices}, for each of a ``FleetRunner.run``'s
    launches (blocking, EBF)."""
    out = {}
    for cls in ("blocking", "ebf"):
        idx = [i for i, s in enumerate(sims)
               if (s.sched_id == SCHED_EBF) == (cls == "ebf")]
        if idx:
            f = res.finals[idx[0]]
            out[cls] = (idx, [sims[i].state.pad_to(
                f.n_rows, f.assigned.shape[1], f.fail_ev.shape[0],
                f.tele_buf.shape[0]) for i in idx])
    return out


def launch_device_ms(launches):
    """The profiler's device time of ``fleet_engine`` per launch (worker
    process, on the card): ``launches`` maps a name to the states of one
    launch; each is stacked and advanced once under the profiler."""
    dev = torch.device("cuda")
    out = {}
    for name, states in launches.items():
        batch = stack(states, dev)
        torch.cuda.synchronize()
        with torch.profiler.profile(
                activities=[torch.profiler.ProfilerActivity.CUDA]) as prof:
            advance(batch)
            torch.cuda.synchronize()
        out[name] = device_time_us(prof)[0] * 1e-3
    return out


def time_launches(res, sims, grid, dev):
    """The launches of a ``FleetRunner.run`` again, one per cost class:
    ``advance`` alone on the states the runner padded, stacked on the
    card, timed with CUDA events; its finals must equal the run's.  Logs
    one line per launch (kernel ms, us per event per sim) and returns
    {cost class: ms}."""
    times = {}
    for cls, (idx, states) in launch_states(res, sims).items():
        batch = stack(states, dev)
        start = torch.cuda.Event(enable_timing=True)
        end = torch.cuda.Event(enable_timing=True)
        torch.cuda.synchronize()
        start.record()
        advance(batch)
        end.record()
        end.synchronize()
        ms = start.elapsed_time(end)
        for i, g in zip(idx, unstack(batch)):
            for k in SimState._fields:
                if not np.array_equal(getattr(g, k), getattr(res.finals[i], k)):
                    raise AssertionError(f"{grid} {sims[i].name}: the timed "
                                         f"launch differs in {k}")
        events = sum(int(res.finals[i].n_events) for i in idx)
        log({"phase": "fleet_launch", "grid": grid, "launch": cls,
             "sims": len(idx), "events": events, "ms": ms,
             "us_per_event_per_sim": ms * 1e3 * len(idx) / events})
        times[cls] = ms
    return times


def fleet_seth_grid(dev):
    """Phase 8: 8 policies x 16 seeds of Seth in one FleetRunner.run,
    then each of its two launches timed alone."""
    t0 = time.perf_counter()
    bases = [FleetRunner.build("seth", seth_jobs(SETH_JOBS, seed), SETH,
                               SCHED_FIFO, seed=seed)
             for seed in range(FLEET_SEEDS)]
    sims = [sim for seed, b in enumerate(bases)
            for sim in policy_sims(b, seed, f"-s{seed}")]
    build_s = time.perf_counter() - t0
    counters.reset_device_launches()
    res, wall, ours, total = run_fleet(sims, profile=True)
    launches = counters.device_launch_stats()
    events = sum(int(f.n_events) for f in res.finals)
    for i in range(len(sims)):
        check_invariants(res, i)
    twin_events = twin_wall = 0
    for i, (sc, ac) in enumerate(POLICIES):        # seed 0 comes first
        rec, summ, tw = TWINS[("seth", tag_of(sc, ac))]
        check_against_twin(res, i, rec, summ, f"seth grid {sims[i].name}")
        twin_events += summ["events"]
        twin_wall += tw
    # two lanes of the grid against their solo launches
    names = [sim.name for sim in sims]
    for i in (names.index("EBF-BF-s5"), names.index("SJF-FF-s11")):
        solo = FleetRunner().run([sims[i]])
        for k in SimState._fields:
            if not np.array_equal(getattr(solo.finals[0], k),
                                  getattr(res.finals[i], k)):
                raise AssertionError(f"{sims[i].name}: solo launch differs "
                                     f"in {k}")
    time_launches(res, sims, "seth", dev)
    log({"phase": "fleet_seth", "sims": len(sims), "seeds": FLEET_SEEDS,
         "jobs_per_sim": SETH_JOBS, "build_s": build_s, "events": events,
         "wall_s": wall, "events_per_s": events / wall,
         "launches": res.launches, "fleet_wall_time_s": res.wall_time_s,
         "kernel_device_s": ours, "device_busy_share": total / wall,
         "twins_events_per_s": twin_events / twin_wall,
         "twins_events_per_s_each": [TWINS[("seth", tag_of(*p))][1]["events"]
                                     / TWINS[("seth", tag_of(*p))][2]
                                     for p in POLICIES],
         "grid_over_one_twin": (events / wall) / (twin_events / twin_wall),
         "seed0_equal_to_twins": True, "invariants": True,
         "solo_launches_equal": True, "cuda_launches": launches})
    return launches, {"shape": [len(sims), res.finals[0].n_rows,
                                SETH["nodes"]["seth"], 2],
                      "ms": wall * 1e3, "device_ms": ours * 1e3,
                      "bytes": batch_bytes(res.finals)}


class TwinRun:
    """What a numpy twin run in a worker process hands back: the
    Recorder's per-event traces and queue lengths, the summary, the
    wall time, and (failure twins) the job records and telemetry."""

    def __init__(self, rec, summary, wall, records=None, telemetry=None):
        self.traces, self.queues = rec.traces, rec.queues
        self.summary, self.wall = summary, wall
        self.records, self.telemetry = records, telemetry


def make_sched(tag):
    sched, alloc = tag.split("-")
    return {"FIFO": FirstInFirstOut, "SJF": ShortestJobFirst,
            "LJF": LongestJobFirst, "EBF": EasyBackfilling}[sched](
        {"FF": FirstFit, "BF": BestFit}[alloc]())


def seth_failures():
    """Seth seed 0's FAIL/REPAIR schedule, over its submission span."""
    horizon = max(j.submission_time for j in seth_jobs(SETH_JOBS))
    return horizon, FailureInjector(
        SETH["nodes"]["seth"], mtbf_s=FAIL_MTBF_S, repair_s=FAIL_REPAIR_S,
        horizon_s=horizon, seed=FAIL_SEED)


def twin_job(system, tag, max_events=None, failures=False):
    """A numpy twin (worker process): the RICC-sized or the Intrepid-sized
    system, or Seth under the failure schedule with checkpoint credit, a
    quarantine and telemetry."""
    torch.set_num_threads(1)
    rec = Recorder(make_sched(tag))
    kw, jobs = {}, ricc_jobs(Job, RICC_JOBS)
    if system == INTREPID:
        jobs = intrepid_jobs(Job)
    if failures:
        kw = dict(failures=seth_failures()[1],
                  checkpoint=CheckpointRestartPolicy(CKPT_EVERY_S),
                  quarantine_s=QUARANTINE_S, telemetry_stride=TELE_STRIDE)
        jobs = seth_jobs(SETH_JOBS)
    with tempfile.TemporaryDirectory() as td:
        sim = Simulator(jobs, system, rec, output_dir=td, name="twin", **kw)
        t0 = time.perf_counter()
        out = sim.start_simulation(write_output=failures,
                                   max_events=max_events)
        wall = time.perf_counter() - t0
        records = None
        if failures:
            with open(out) as fh:
                records = {str(r["id"]): [r["start"], list(r["assigned"]),
                                          r["state"]]
                           for r in map(json.loads, fh)}
    return TwinRun(rec, sim.summary, wall, records,
                   getattr(sim, "telemetry", None))


def plain_job(states, use_kernel):
    """advance_plain on CPU tensors (worker process): numpy finals."""
    torch.set_num_threads(1)
    return [SimState(*(x.numpy() for x in advance_plain(st, use_kernel)))
            for st in plain_states(states)]


def fleet_ricc(twins, dev):
    """Phase 9: the 8 policies on the RICC-sized system, each of its two
    launches timed alone; returns a function that then holds the 6
    blocking rows to the end against numpy twins and the EBF rows against
    twins cut at RICC_MAX_EVENTS events (``twins``: tag -> pending
    TwinRun), logs the phase and returns its CUDA launches, so that the
    card can go on while the twins run."""
    base = FleetRunner.build("ricc", ricc_jobs(Job, RICC_JOBS), RICC,
                             SCHED_FIFO)
    sims = policy_sims(base)
    counters.reset_device_launches()
    res, wall, ours, total = run_fleet(sims, profile=True)
    launches = counters.device_launch_stats()
    for i in range(len(sims)):
        check_invariants(res, i)
    time_launches(res, sims, "ricc", dev)

    def against_twins():
        rows = []
        for i, (sc, ac) in enumerate(POLICIES):
            tag = tag_of(sc, ac)
            label, f = f"ricc {tag}", res.finals[i]
            got = TWINS.get(("ricc", tag)) if sc == SCHED_EBF else None
            if got:                              # phase 3's twin
                rec, summ, tw = got
            else:
                twin = twins[tag].get()
                rec, summ, tw = twin, twin.summary, twin.wall
            row = {"row": tag, "events": int(f.n_events), "twin_wall_s": tw,
                   "twin_events": summ["events"],
                   "twin_events_per_s": summ["events"] / tw}
            if sc == SCHED_EBF:
                row["checked_dispatch_events"] = check_prefix(res, i, rec,
                                                              label)
            else:
                check_against_twin(res, i, rec, summ, label)
            rows.append(row)
        events = sum(int(f.n_events) for f in res.finals)
        log({"phase": "fleet_ricc", "sims": len(sims), "jobs": RICC_JOBS,
             "nodes": RICC["nodes"]["ricc"], "events": events,
             "wall_s": wall, "events_per_s": events / wall,
             "launches": res.launches, "kernel_device_s": ours,
             "device_busy_share": total / wall, "rows": rows,
             "equal_to_twins": True, "invariants": True,
             "cuda_launches": launches})
        return launches
    return against_twins


def fleet_failures(twins):
    """Phase 10: Seth under a seeded FAIL/REPAIR schedule with checkpoint
    credit, a quarantine and telemetry: FIFO-FF and EBF-BF against the
    host Simulator(failures=...) twin (``twins``: tag -> pending
    TwinRun)."""
    horizon, inj = seth_failures()
    tags = [("FIFO-FF", SCHED_FIFO, ALLOC_FF), ("EBF-BF", SCHED_EBF, ALLOC_BF)]
    sims = [FleetRunner.build(tag, seth_jobs(SETH_JOBS), SETH, sc,
                              alloc_id=ac, failures=inj,
                              quarantine_s=QUARANTINE_S,
                              ckpt_every_s=CKPT_EVERY_S,
                              telemetry_stride=TELE_STRIDE)
            for tag, sc, ac in tags]
    counters.reset_device_launches()
    res, wall, _, _ = run_fleet(sims)
    launches = counters.device_launch_stats()
    rows = []
    for i, (tag, _, _) in enumerate(tags):
        check_invariants(res, i)
        host = twins[tag].get()
        got, want = res.trace(i), host.records
        diff = [j for j in want if want[j] != got.get(j)]
        if diff or set(got) != set(want):
            raise AssertionError(f"failures {tag}: {len(diff)} jobs differ "
                                 f"from the host twin")
        summ = res.summary(i)
        if summ["failures"] != host.summary["failures"]:
            raise AssertionError(f"failures {tag}: counters "
                                 f"{summ['failures']} != "
                                 f"{host.summary['failures']}")
        if host.summary["failures"]["requeued_jobs"] == 0:
            raise AssertionError(f"failures {tag}: no job was requeued")
        host.telemetry.assert_parity(res.telemetry(i))
        rows.append({"row": tag, "events": summ["events"],
                     "failures": summ["failures"],
                     "telemetry_samples": res.telemetry(i).n_samples,
                     "phase_counters": summ["telemetry"]["phase_counters"],
                     "host_wall_s": host.wall})
    log({"phase": "fleet_failures", "fail_events": int(inj.times.shape[0]),
         "horizon_s": horizon, "wall_s": wall, "launches": res.launches,
         "rows": rows, "equal_to_host": True, "cuda_launches": launches})
    return launches


def fleet_intrepid(dev, twins):
    """Phase 11b: the 8 policies on the Intrepid-sized system (40,960
    nodes, past one block's shared memory: the kernel's global tier), in
    one ``FleetRunner().run``, every sim against its numpy twin run to the
    end (``twins``: tag -> pending TwinRun); its two launches timed alone
    with CUDA events, and their device time read by the profiler in a
    fresh process."""
    t0 = time.perf_counter()
    base = FleetRunner.build("intrepid", intrepid_jobs(Job), INTREPID,
                             SCHED_FIFO)
    sims = policy_sims(base)
    build_s = time.perf_counter() - t0
    n, r = base.state.avail.shape
    smem = build.library("fleet_engine").fleet_engine_shared_bytes(
        n, r, build.device_index(dev))
    if smem != 0:
        raise AssertionError(f"intrepid: {smem} bytes of shared memory, "
                             f"not the global tier")
    counters.reset_device_launches()
    res, wall, _, _ = run_fleet(sims)
    launches = counters.device_launch_stats()
    if not launches.get("fleet_engine"):
        raise AssertionError("fleet intrepid: no CUDA launch of "
                             "fleet_engine")
    # the card's work first, while the twins may still be running
    ms = time_launches(res, sims, "intrepid", dev)
    with multiprocessing.get_context("spawn").Pool(1) as pool:
        device = pool.apply(launch_device_ms, ({
            cls: states for cls, (_, states) in
            launch_states(res, sims).items()},))
    rows = []
    for i, (sc, ac) in enumerate(POLICIES):
        tag = tag_of(sc, ac)
        check_invariants(res, i)
        twin = twins[tag].get()
        check_against_twin(res, i, twin, twin.summary, f"intrepid {tag}")
        q0 = res.finals[i].log_queue + res.finals[i].log_started
        rows.append({"row": tag, "events": int(res.finals[i].n_events),
                     "max_queue": int(q0[:int(res.finals[i].n_events)].max()),
                     "twin_wall_s": twin.wall,
                     "twin_events_per_s": twin.summary["events"] / twin.wall})
    events = sum(int(f.n_events) for f in res.finals)
    nbytes = batch_bytes(res.finals)
    b_ms, b_by = bound("fleet_engine", (nbytes,))
    log({"phase": "fleet_intrepid", "sims": len(sims),
         "jobs": INTREPID_JOBS, "nodes": n, "R": r,
         "K": int(res.finals[0].assigned.shape[1]), "tier": "global",
         "build_s": build_s, "events": events, "wall_s": wall,
         "events_per_s": events / wall, "launches": res.launches,
         "launch_ms": ms, "device_ms": device, "bytes": nbytes,
         "bound_ms": b_ms, "bound_by": b_by, "rows": rows,
         "equal_to_twins": True, "invariants": True,
         "cuda_launches": launches})
    log({"phase": "kernel", "name": "fleet_engine", "path": "intrepid",
         "shape": [len(sims), res.finals[0].n_rows, n, r],
         "launches": launches["fleet_engine"], "ms": ms,
         "device_ms": device, "bound_ms": b_ms, "bound_by": b_by})
    return launches


def plain_states(states):
    """Unbatched CPU tensors of numpy states, for the plain version."""
    return [SimState(*(torch.from_numpy(np.asarray(x, dtype=np.int32))
                       for x in st)) for st in states]


def plain_cases():
    """The small cases the kernel is held against its plain version on:
    the golden scenario's 8 policies with and without the prefilter, a
    failure schedule with telemetry (the reference's failure tests'
    scenario) with and without it, and those lanes padded."""
    golden = [s.state for s in policy_sims(FleetRunner.build(
        "golden", SyntheticWorkload(400, seed=29, **GOLDEN_WL), GOLDEN,
        SCHED_FIFO, job_factory=JobFactory()))]
    failing = [s.state for s in policy_sims(FleetRunner.build(
        "failing", SyntheticWorkload(150, seed=7, **GOLDEN_WL), GOLDEN,
        SCHED_FIFO, job_factory=JobFactory(),
        failures=FailureInjector(10, mtbf_s=4000.0, repair_s=900.0,
                                 horizon_s=6000, seed=3),
        quarantine_s=1800, ckpt_every_s=600, telemetry_stride=5))]
    m, k = failing[0].n_rows, failing[0].assigned.shape[1]
    f, ts = failing[0].fail_ev.shape[0], failing[0].tele_buf.shape[0]
    padded = [s.pad_to(m + 37, k + 5, f + 16, ts + 64) for s in failing]
    return [("golden", golden, False), ("golden", golden, True),
            ("failures+telemetry", failing, False),
            ("failures+telemetry", failing, True), ("padded", padded, True)]


def golden_device_ms(state, launches=4):
    """The profiler's device time of one ``fleet_engine`` launch on
    ``state`` (worker process, on the card): a warm-up launch, then
    ``launches`` profiled ones."""
    dev = torch.device("cuda")
    base = stack([state], dev)
    copies = [SimState(*(t.clone() for t in base))
              for _ in range(launches + 1)]
    advance(copies[0])
    torch.cuda.synchronize()
    with torch.profiler.profile(
            activities=[torch.profiler.ProfilerActivity.CUDA]) as prof:
        for c in copies[1:]:
            advance(c)
        torch.cuda.synchronize()
    return device_time_us(prof)[0] * 1e-3 / launches


def fleet_kernel_vs_plain(dev, cases, plains):
    """Phase 11: the kernel against advance_plain (``plains``, pending
    from worker processes, on the same inputs) on ``cases``, the whole
    final SimState equal; then the kernel's time and the plain version's
    on the card at the golden EBF-BF case."""
    n_sims = 0
    for (name, states, use_kernel), pending in zip(cases, plains):
        got = unstack(advance(stack(states, dev), use_kernel))
        for g, want in zip(got, pending.get()):
            for key in SimState._fields:
                if not np.array_equal(getattr(g, key), getattr(want, key)):
                    raise AssertionError(f"fleet_engine {name} "
                                         f"use_kernel={use_kernel}: {key} "
                                         f"differs from advance_plain")
            n_sims += 1
    one = cases[0][1][POLICIES.index((SCHED_EBF, ALLOC_BF))]
    base = stack([one], dev)
    copies = [SimState(*(t.clone() for t in base)) for _ in range(5)]
    advance(copies[0])
    torch.cuda.synchronize()
    start = torch.cuda.Event(enable_timing=True)
    end = torch.cuda.Event(enable_timing=True)
    start.record()
    for c in copies[1:5]:
        advance(c)
    end.record()
    end.synchronize()
    ms = start.elapsed_time(end) / 4
    # the profiler's device time, in a fresh process: this one's earlier
    # profiler sessions leave it recording no kernel of this window
    with multiprocessing.get_context("spawn").Pool(1) as pool:
        device = pool.apply(golden_device_ms, (one,))
    if not device > 0:
        raise AssertionError("fleet_engine golden: the profiler recorded no "
                             "kernel")
    on_card = SimState(*(t[0] for t in stack([one], dev)))
    t0 = time.perf_counter()
    plain = advance_plain(on_card, False)
    torch.cuda.synchronize()
    plain_ms = (time.perf_counter() - t0) * 1e3
    for key, a, b in zip(SimState._fields, plain, copies[0]):
        if not torch.equal(a, b[0]):
            raise AssertionError(f"fleet_engine: {key} differs from the "
                                 f"plain version on the card")
    b_ms, b_by = bound("fleet_engine", (batch_bytes([one]),))
    log({"phase": "kernel", "name": "fleet_engine", "path": "golden",
         "cases": len(cases), "sims": n_sims,
         "shape": [1, one.n_rows, one.n_nodes, one.avail.shape[1]],
         "events": int(copies[0].n_events[0]), "ms": ms,
         "device_ms": device,
         "plain_ms_on_card": plain_ms, "bound_ms": b_ms, "bound_by": b_by,
         "max_abs_err": 0.0})
    return ms, plain_ms, b_ms, b_by


def fleet_twins(pool, cases):
    """Queues phases 8-11's host work on ``pool`` (numpy twins and the
    plain runs of ``cases``), the longest first: the Intrepid-sized EBF
    rows, then RICC's blocking rows.  Returns the pending results, for
    ``fleet``."""
    intrepid = {tag_of(sc, ac): pool.apply_async(twin_job, (
        INTREPID, tag_of(sc, ac))) for sc, ac in POLICIES
        if sc == SCHED_EBF}
    ricc = {tag_of(sc, ac): pool.apply_async(twin_job, (
        RICC, tag_of(sc, ac))) for sc, ac in reversed(POLICIES)
        if sc != SCHED_EBF}
    ricc["EBF-FF"] = pool.apply_async(
        twin_job, (RICC, "EBF-FF", RICC_MAX_EVENTS))
    intrepid.update({tag_of(sc, ac): pool.apply_async(twin_job, (
        INTREPID, tag_of(sc, ac))) for sc, ac in POLICIES
        if sc != SCHED_EBF})
    failing = {tag: pool.apply_async(twin_job, (SETH, tag, None, True))
               for tag in ("FIFO-FF", "EBF-BF")}
    plains = [pool.apply_async(plain_job, (states, use_kernel))
              for _, states, use_kernel in cases]
    return intrepid, ricc, failing, plains


def fleet(dev, cases, pending):
    """Phases 8-11; returns the kernel table's fleet_engine row.  The
    numpy twins of phases 9-11b and the plain runs of phase 11
    (``pending``, from ``fleet_twins``) run in worker processes while
    the card runs the fleet: phase 8, phase 9's runs, phase 11b, by
    whose end phase 9's twins are done, then phase 9's checks, 10 and
    11."""
    intrepid_twins, ricc_twins, fail_twins, plains = pending
    t0 = time.perf_counter()
    seth_launches, grid = fleet_seth_grid(dev)
    ricc_against_twins = fleet_ricc(ricc_twins, dev)
    intrepid_launches = fleet_intrepid(dev, intrepid_twins)
    ricc_launches = ricc_against_twins()
    fail_launches = fleet_failures(fail_twins)
    ms, plain_ms, b_ms, b_by = fleet_kernel_vs_plain(dev, cases, plains)
    log({"phase": "fleet", "total_s": time.perf_counter() - t0})
    launches = sum(d.get("fleet_engine", 0) for d in (
        seth_launches, ricc_launches, fail_launches, intrepid_launches))
    for name, got in (("seth", seth_launches), ("ricc", ricc_launches),
                      ("failures", fail_launches),
                      ("intrepid", intrepid_launches)):
        if not got.get("fleet_engine"):
            raise AssertionError(f"fleet {name}: no CUDA launch of "
                                 f"fleet_engine")
    b_grid, _ = bound("fleet_engine", (grid["bytes"],))
    log({"phase": "kernel", "name": "fleet_engine", "path": "seth_grid",
         "shape": grid["shape"], "launches": seth_launches["fleet_engine"],
         "wall_ms": grid["ms"], "device_ms": grid["device_ms"],
         "bound_ms": b_grid, "bound_by": "bytes"})
    src, replaces, _ = KERNELS["fleet_engine"]
    return {"name": "fleet_engine", "route": "cuda", "source": src,
            "replaces": replaces, "launches": launches, "max_abs_err": 0.0,
            "ms": ms, "plain_ms": plain_ms, "bound_ms": b_ms,
            "bound_by": b_by, "library_ms": None}


# ----------------------------------------------------------------------
# the Experiment layer: the paper's Table-2 study and a policy study
# ----------------------------------------------------------------------
def study_workload():
    """The policy study's workload: SyntheticWorkload on the Seth system,
    its repeats reseeded from the base seed on by the Experiment."""
    return SyntheticWorkload(STUDY_JOBS, seed=STUDY_SEED, **STUDY_WL)


def host_twin(root, name, workload, tag):
    """One dispatcher through ``Experiment(use_fleet=False)`` (worker
    process, host only): (summary, output path, wall s)."""
    torch.set_num_threads(1)
    exp = Experiment(name, workload, SETH, output_dir=os.path.join(root, tag),
                     use_fleet=False)
    exp.add_dispatcher(make_sched(tag))
    t0 = time.perf_counter()
    res = exp.run_simulation(produce_plots=False)[tag]
    return res["summaries"][0], res["output"], time.perf_counter() - t0


def table2_twin(root, tag, n_jobs=TABLE2_JOBS):
    return host_twin(root, "table2", list(seth_jobs(n_jobs, TABLE2_SEED)),
                     tag)


def study_twin(root, tag):
    return host_twin(root, "study", study_workload(), tag)


def job_records(path):
    """A ``-output.jsonl`` as {job id: record} (the host writes records in
    completion order, the fleet in row order)."""
    with open(path, "rb") as fh:
        recs = [json.loads(line) for line in fh]
    out = {r["id"]: r for r in recs}
    if len(out) != len(recs):
        raise AssertionError(f"{path}: a job id appears twice")
    return out


def check_against_host(summ, out_path, twin, label):
    """A row's job records and summary counters against a host twin's."""
    t_summ, t_out, _ = twin
    if job_records(out_path) != job_records(t_out):
        raise AssertionError(f"{label}: job records differ from the host")
    for k in ("events", "submitted", "completed", "rejected",
              "sim_end_time"):
        if summ[k] != t_summ[k]:
            raise AssertionError(f"{label}: summary {k} {summ[k]} != "
                                 f"{t_summ[k]}")


class FleetSplit:
    """Inside ``patched()``: times each ``FleetRunner.run`` and
    ``FleetResult.write_outputs`` that an ``Experiment`` makes, and keeps
    the ``FleetResult`` for the invariant checks.  It wraps the two
    methods; the Experiment's code is the port's own."""

    def __init__(self) -> None:
        self.results, self.run_s, self.write_s = [], 0.0, 0.0
        self.run_start = self.write_end = None

    @contextlib.contextmanager
    def patched(self):
        run, write = FleetRunner.run, FleetResult.write_outputs

        def timed_run(runner, sims, *args, **kw):
            t0 = time.perf_counter()
            self.run_start = self.run_start or t0
            res = run(runner, sims, *args, **kw)
            self.run_s += time.perf_counter() - t0
            self.results.append(res)
            return res

        def timed_write(res, output_dir, i):
            t0 = time.perf_counter()
            paths = write(res, output_dir, i)
            self.write_end = time.perf_counter()
            self.write_s += self.write_end - t0
            return paths

        FleetRunner.run, FleetResult.write_outputs = timed_run, timed_write
        try:
            yield self
        finally:
            FleetRunner.run, FleetResult.write_outputs = run, write


def experiment_table2(dev, td, twins, vx_twins, produce_plots):
    """Phase 12: ``benchmarks_torch/table2_dispatchers.run`` on the card
    (8,000 Seth jobs, the 8 policies on the fleet: 2 launches), each row
    against the same dispatcher through ``Experiment(use_fleet=False)``
    (``twins``: tag -> pending host twin); then the reference example's
    three vectorized rows through an ``Experiment`` on the card, on the
    stream's first TABLE2_VX_JOBS jobs, each against its numpy twin on
    those jobs (``vx_twins``).  Returns the CUDA launches of both
    runs."""
    split = FleetSplit()
    counters.reset_device_launches()
    t0 = time.perf_counter()
    with split.patched():
        rows = table2_dispatchers.run(out_dir=td, n_jobs=TABLE2_JOBS,
                                      device=dev, produce_plots=produce_plots)
    torch.cuda.synchronize()
    wall = time.perf_counter() - t0
    launches = counters.device_launch_stats()
    if launches != {"fleet_engine": 2}:
        raise AssertionError(f"table2: CUDA launches {launches}, not 2 of "
                             f"fleet_engine")
    (res,) = split.results
    for i in range(len(res)):
        check_invariants(res, i)
    with open(os.path.join(td, "table2", "summaries.json")) as fh:
        summaries = json.load(fh)
    tags = [tag_of(sc, ac) for sc, ac in POLICIES]
    if list(summaries) != tags:
        raise AssertionError(f"table2: rows {list(summaries)}")
    host = {}
    for tag in tags:
        (summ,) = summaries[tag]
        if summ["engine"] != "fleet":
            raise AssertionError(f"table2 {tag}: engine {summ['engine']}")
        host[tag] = twins[tag].get()
        check_against_host(summ, os.path.join(
            td, "table2", f"{tag}-output.jsonl"), host[tag], f"table2 {tag}")
    log({"phase": "experiment_table2", "jobs": TABLE2_JOBS, "wall_s": wall,
         "plots": produce_plots, "launches": res.launches,
         "fleet_run_s": split.run_s, "write_outputs_s": split.write_s,
         "rows": rows, "host_wall_s": {t: h[2] for t, h in host.items()},
         "equal_to_host": True, "invariants": True,
         "cuda_launches": launches})

    # the reference example's vectorized rows, on the card
    exp = Experiment("table2_vectorized", list(seth_jobs(TABLE2_VX_JOBS,
                                                         TABLE2_SEED)),
                     SETH, output_dir=td, device=dev)
    alloc = lambda pol: VectorizedAllocator(pol, device=dev)
    exp.add_dispatcher(FirstInFirstOut(alloc("FF")))
    exp.add_dispatcher(FirstInFirstOut(alloc("BF")))
    exp.add_dispatcher(VectorizedEasyBackfilling(alloc("FF")))
    counters.reset_device_launches()
    t0 = time.perf_counter()
    res = exp.run_simulation(produce_plots=False)
    torch.cuda.synchronize()
    wall = time.perf_counter() - t0
    vx_launches = counters.device_launch_stats()
    for k in ("alloc_score_batch", "ebf_shadow"):
        if not vx_launches.get(k):
            raise AssertionError(f"table2 vectorized rows: no CUDA launch "
                                 f"of {k}")
    vx_rows = {}
    for tag, twin in (("FIFO-vFF", "FIFO-FF"), ("FIFO-vBF", "FIFO-BF"),
                      ("vEBF-vFF", "EBF-FF")):
        host_vx = vx_twins[twin].get()
        (summ,) = res[tag]["summaries"]
        if (summ["engine"], summ["fallback_reason"]) != (
                "host", "non-compilable-dispatcher"):
            raise AssertionError(f"table2 {tag}: {summ['engine']}, "
                                 f"{summ['fallback_reason']}")
        check_against_host(summ, res[tag]["output"], host_vx,
                           f"table2 {tag}")
        with open(res[tag]["output"], "rb") as a, \
                open(host_vx[1], "rb") as b:
            if a.read() != b.read():
                raise AssertionError(f"table2 {tag}: output not byte-equal "
                                     f"to {twin}'s")
        vx_rows[tag] = {"twin": twin, "events": summ["events"],
                        "events_per_s": summ["events"] / summ["wall_time_s"],
                        "launches_per_event":
                            summ["kernel_launches_per_event"],
                        "twin_events_per_s": summ["events"] / host_vx[2]}
    log({"phase": "experiment_table2", "vectorized_rows": vx_rows,
         "jobs": TABLE2_VX_JOBS,
         "wall_s": wall, "equal_to_numpy_twins": True,
         "cuda_launches": vx_launches})
    return {k: launches.get(k, 0) + vx_launches.get(k, 0)
            for k in set(launches) | set(vx_launches)}


def experiment_study(dev, td, twins):
    """Phase 13: ``Experiment`` over the 8 policies x STUDY_REPEATS
    repeats of a STUDY_JOBS-job SyntheticWorkload on Seth, one
    ``run_simulation`` on the card (2 ``fleet_engine`` launches), under
    the profiler for
    its device busy share; every row's invariants, its engine and seed,
    and FIFO-FF r0 and EBF-BF r0 against host twins (``twins``)."""
    exp = Experiment("study", study_workload(), SETH, output_dir=td,
                     repeats=STUDY_REPEATS, device=dev)
    exp.gen_dispatchers([FirstInFirstOut, ShortestJobFirst, LongestJobFirst,
                         EasyBackfilling], [FirstFit, BestFit])
    split = FleetSplit()
    counters.reset_device_launches()
    with split.patched(), torch.profiler.profile(
            activities=[torch.profiler.ProfilerActivity.CUDA]) as prof:
        t0 = time.perf_counter()
        res = exp.run_simulation(produce_plots=False)
        torch.cuda.synchronize()
        t_end = time.perf_counter()
    launches = counters.device_launch_stats()
    if launches != {"fleet_engine": 2}:
        raise AssertionError(f"study: CUDA launches {launches}, not 2 of "
                             f"fleet_engine")
    ours, total = (x * 1e-6 for x in device_time_us(prof))
    if not ours > 0:
        raise AssertionError("study: the profiler recorded no kernel")
    (fres,) = split.results
    if len(fres) != len(POLICIES) * STUDY_REPEATS:
        raise AssertionError(f"study: {len(fres)} sims")
    for i in range(len(fres)):
        check_invariants(fres, i)
    seeds = list(range(STUDY_SEED, STUDY_SEED + STUDY_REPEATS))
    for tag, entry in res.items():
        summ = entry["summaries"]
        if {s["engine"] for s in summ} != {"fleet"} or [
                s["seed"] for s in summ] != seeds:
            raise AssertionError(f"study {tag}: engines or seeds differ")
    host = {}
    for tag, twin in twins.items():
        host[tag] = twin.get()
        check_against_host(res[tag]["summaries"][0], os.path.join(
            td, "study", f"{tag}-r0-output.jsonl"), host[tag],
            f"study {tag}-r0")
    wall = t_end - t0
    events = sum(s["events"] for e in res.values() for s in e["summaries"])
    f0 = fres.finals[0]
    b_ms, b_by = bound("fleet_engine", (batch_bytes(fres.finals),))
    log({"phase": "experiment_study", "sims": len(fres),
         "shape": [len(fres), f0.n_rows, f0.n_nodes, f0.avail.shape[1]],
         "bound_ms": b_ms, "bound_by": b_by,
         "jobs_per_sim": STUDY_JOBS, "workload": STUDY_WL, "seeds":
         [seeds[0], seeds[-1]], "events": events, "wall_s": wall,
         "plan_and_build_s": split.run_start - t0, "run_s": split.run_s,
         "write_outputs_s": split.write_s,
         "summaries_json_s": t_end - split.write_end,
         "launches": fres.launches, "kernel_device_s": ours,
         "device_busy_share": total / wall, "events_per_s": events / wall,
         "host_twins": {t: {"events": h[0]["events"], "wall_s": h[2]}
                        for t, h in host.items()},
         "equal_to_host_twins": True, "invariants": True,
         "cuda_launches": launches})
    return launches


def experiment_twins(pool, td):
    """Queues phases 12-13's host twins on ``pool``, their outputs under
    ``td``: the Table-2 rows, the vectorized rows' twins on the first
    TABLE2_VX_JOBS jobs, and two rows of the policy study.  Returns the
    pending results, for ``experiment``."""
    t2 = {tag: pool.apply_async(table2_twin, (os.path.join(td, "host"),
                                              tag))
          for tag in (tag_of(sc, ac) for sc, ac in POLICIES)}
    st = {tag: pool.apply_async(study_twin, (os.path.join(td, "host"),
                                             tag))
          for tag in ("FIFO-FF", "EBF-BF")}
    vx = {tag: pool.apply_async(table2_twin, (
        os.path.join(td, "host_vx"), tag, TABLE2_VX_JOBS))
        for tag in ("FIFO-FF", "FIFO-BF", "EBF-FF")}
    return t2, st, vx


def experiment(dev, td, pending):
    """Phases 12-13, their outputs under ``td``; returns their CUDA
    launches.  The host twins (``pending``, from ``experiment_twins``)
    were queued before the fleet phases and run in worker processes."""
    produce_plots = importlib.util.find_spec("matplotlib") is not None
    t2, st, vx = pending
    t0 = time.perf_counter()
    table2_launches = experiment_table2(dev, os.path.join(td, "card"),
                                        t2, vx, produce_plots)
    study_launches = experiment_study(dev, os.path.join(td, "card"), st)
    log({"phase": "experiment", "total_s": time.perf_counter() - t0})
    return {k: table2_launches.get(k, 0) + study_launches.get(k, 0)
            for k in set(table2_launches) | set(study_launches)}


# ----------------------------------------------------------------------
# 14. the benchmark modes
# ----------------------------------------------------------------------
BENCH_KERNELS = {"alloc_score", "alloc_score_batch", "ebf_shadow",
                 "fleet_engine"}


def bench_modes(dev):
    """Phase 14; returns its CUDA launches.  Each mode runs through its
    ``run`` on the card and refuses by itself (an ``AssertionError`` or
    ``SystemExit`` ends the smoke); then ``bench_kernels``' widest inputs
    go through the two dispatch kernels against their plain versions,
    outside the counted run."""
    modes = (
        ("dispatch", lambda out: bench_dispatch.run(out, quick=True),
         lambda r: {"headline": r["headline"], "device": r["mode"],
                    "speedup_batched_vs_per_job":
                        r["speedup_batched_vs_per_job"],
                    "events_per_s": {c["engine"]: c["events_per_s"]
                                     for c in r["cells"]}}),
        ("fleet", lambda out: bench_fleet.run(out, quick=True),
         lambda r: {"n_sims": r["n_sims"], "host": r["host"],
                    "fleet": {k: v for k, v in r["fleet"].items()
                              if k != "launches"},
                    "launches": r["fleet"]["launches"],
                    "speedup": r["speedup_aggregate_events_per_s"]}),
        ("failures", lambda out: bench_failures.run(out, quick=True),
         lambda r: {"scale_cell": r["scale_cell"],
                    "crosscheck_host": r["crosscheck"]["host"],
                    "crosscheck_fleet": r["crosscheck"]["fleet"]}),
        ("profile", lambda out: bench_profile.run(out, quick=True),
         lambda r: {k: r[k] for k in ("n_sims", "events", "telemetry_off",
                                      "telemetry_on", "overhead_fraction",
                                      "overhead_ok")}),
        ("kernels", lambda out: bench_kernels.run(out),
         lambda r: r),
    )
    t_all = time.perf_counter()
    with tempfile.TemporaryDirectory() as td:
        for mod in (bench_dispatch, bench_fleet, bench_failures,
                    bench_profile):
            mod.REPO_ROOT = td
        out = os.path.join(td, "bench")
        counters.reset_device_launches()
        per_mode, before = {}, {}
        for name, call, head in modes:
            t0 = time.perf_counter()
            result = call(out)
            wall = time.perf_counter() - t0
            now = counters.device_launch_stats()
            per_mode[name] = {k: v - before.get(k, 0) for k, v in now.items()
                              if v > before.get(k, 0)}
            before = now
            log({"phase": "bench_modes", "mode": name, "wall_s": wall,
                 "cuda_launches": per_mode[name], **head(result)})
        launches = counters.device_launch_stats()
    log({"phase": "bench_modes", "cuda_launches": launches,
         "total_s": time.perf_counter() - t_all})
    missing = BENCH_KERNELS - set(launches)
    if missing:
        raise AssertionError(f"bench modes: no CUDA launch of "
                             f"{sorted(missing)}")

    # bench_kernels' widest inputs, drawn as its run draws them
    rng = np.random.default_rng(0)
    for n_nodes in bench_kernels.SIZES:
        avail, cap, req, deltas = bench_kernels.draw(rng, n_nodes)
    sparse = bench_kernels.sparse_deltas(deltas)
    sizes = len(bench_kernels.SIZES)       # each size launches as many
    per_size = {k: v // sizes for k, v in per_mode["kernels"].items()}
    kernel_rows(
        "alloc_score", k_alloc.alloc_score, alloc_one_plain,
        {"bench_kernels": tuple(to_dev(x, dev) for x in (avail, cap, req))},
        [], {"bench_kernels": per_size["alloc_score"]},
        lambda a: (1,) + tuple(a[0].shape))
    kernel_rows(
        "ebf_shadow", k_ebf.ebf_shadow, ref.ebf_shadow_sparse_ref,
        {"bench_kernels": (to_dev(avail, dev),)
         + tuple(to_dev(x, dev) for x in sparse)
         + (to_dev(req, dev), bench_kernels.M)},
        [], {"bench_kernels": per_size["ebf_shadow"]},
        lambda a: (a[5],) + tuple(a[0].shape) + (a[2].shape[0],))
    return launches

# ----------------------------------------------------------------------
# 17. the dry-run against the card
# ----------------------------------------------------------------------
def dryrun_child() -> int:
    """Phase 17's dry-runs, in a process of their own (the dry-run makes
    a fake world of ranks; it computes nothing and launches no kernel):
    one ``DRYRUN`` JSON line of records."""
    from repro_torch.launch import dryrun
    from repro_torch.launch.mesh import make_mesh
    mesh = make_mesh((1, 1), ("data", "model"))
    out = {"train": dryrun.run_cell(DRY_ARCH, DRY_SHAPE, "1x1", "baseline",
                                    microbatches=1, remat="full",
                                    mesh=mesh)}
    for n in SERVE_PROMPTS:
        shape = ShapeSpec(f"prefill_{SERVE_SLOTS}x{n}", n, SERVE_SLOTS,
                          "prefill")
        for scan in ("stub", "ref"):
            out[f"{n}_{scan}"] = dryrun.run_cell(
                MAMBA_ARCH, shape, "1x1", "baseline", scan_impl=scan,
                mesh=mesh)
    print("DRYRUN " + json.dumps(out), flush=True)
    return 0


def card_step_child(dev) -> int:
    """Phase 17a's steps on the card, in a fresh process whose allocator
    grows its segments in place (the step's float32 logits and their
    gradients, 10 GB each, leave no room for a fragmented cache): one
    ``CARDSTEP`` JSON line of step seconds, losses and peak bytes."""
    cfg = get_config(DRY_ARCH)
    b, n = DRY_SHAPE.global_batch, DRY_SHAPE.seq_len
    model = build_model(cfg, dev)
    params = model.init_params(seed=0)
    ocfg = AdamWConfig()
    opt = adamw_init(params, ocfg)
    step = make_train_step(model, ocfg,
                           TrainStepConfig(microbatches=1, remat="full"))
    batch = copy_task_batch(cfg, b, n, 0, device=dev)
    torch.cuda.synchronize()
    torch.cuda.reset_peak_memory_stats()
    secs, losses = [], []
    for _ in range(DRY_WARM + DRY_STEPS):
        t0 = time.perf_counter()
        params, opt, met = step(params, opt, batch)
        losses.append(float(met["loss"]))               # synchronises
        secs.append(time.perf_counter() - t0)
    print("CARDSTEP " + json.dumps({
        "secs": secs, "losses": losses,
        "peak": torch.cuda.max_memory_allocated()}), flush=True)
    return 0


def child_line(proc, tag, timeout):
    """The JSON after ``tag`` in a child's output; raises if it failed."""
    out, err = proc.communicate(timeout=timeout)
    if proc.returncode != 0:
        raise AssertionError(f"{tag} child: {err[-3000:]}")
    return json.loads([ln for ln in out.splitlines()
                       if ln.startswith(tag + " ")][0][len(tag) + 1:])


def dryrun_vs_card(dev) -> None:
    """Phase 17: the dry-run's bound and memory of a full-size qwen3-1.7b
    train step against the step on the card, and its falcon-mamba-7b
    prefill bounds against phase 5's measured prefills."""
    t_phase = time.perf_counter()
    cfg = get_config(DRY_ARCH)
    b, n = DRY_SHAPE.global_batch, DRY_SHAPE.seq_len
    params_n = cfg.param_count()
    reckon = {"params_gb": 2 * params_n / 1e9,
              "grads_gb": 2 * params_n / 1e9,
              "adamw_state_gb": 8 * params_n / 1e9,
              "adamw_new_state_gb": 8 * params_n / 1e9,
              "logits_gb": (2 + 4) * b * n * cfg.vocab_size / 1e9}
    reckon["total_gb"] = sum(reckon.values())
    log({"phase": "dryrun_card", "arch": cfg.name,
         "memory_before_init": free_card(), "reckoned": reckon})
    me = os.path.abspath(__file__)
    pipes = dict(stdout=subprocess.PIPE, stderr=subprocess.PIPE, text=True)
    child = subprocess.Popen([sys.executable, me, DRYRUN_CHILD_FLAG],
                             **pipes)
    card = subprocess.Popen(
        [sys.executable, me, CARD_STEP_CHILD_FLAG], **pipes,
        env=dict(os.environ,
                 PYTORCH_CUDA_ALLOC_CONF="expandable_segments:True"))
    try:
        stepped = child_line(card, "CARDSTEP", 600)
        recs = child_line(child, "DRYRUN", 600)
    finally:
        for proc in (child, card):
            if proc.poll() is None:
                proc.kill()
                proc.wait()
    secs, losses, peak = stepped["secs"], stepped["losses"], stepped["peak"]
    for key, rec in recs.items():
        if not rec["ok"]:
            raise AssertionError(f"dry-run {key}: {rec.get('traceback')}")
    step_s = statistics.median(secs[DRY_WARM:])
    rec = recs["train"]
    ro, mem = rec["roofline"], rec["memory"]
    log({"phase": "dryrun_card", "arch": cfg.name, "dtype": cfg.dtype,
         "n_layers": cfg.n_layers, "batch": b, "seq": n, "microbatches": 1,
         "remat": "full", "steps": DRY_STEPS, "step_s": step_s,
         "steps_s": secs, "losses": losses,
         "peak_memory_bytes": peak, "dry_compute_s": ro["compute_s"],
         "dry_memory_s": ro["memory_s"], "dry_bound_s":
         ro["bound_step_time_s"], "dry_dominant": ro["dominant"],
         "dry_flops": rec["hlo"]["flops_per_device"],
         "dry_bytes": rec["hlo"]["bytes_per_device"],
         "dry_per_device_bytes": mem["per_device_bytes"],
         "dry_memory": mem, "dry_trace_s": rec["compile_s"],
         "step_over_compute_s": step_s / ro["compute_s"],
         "step_over_bound_s": step_s / ro["bound_step_time_s"],
         "predicted_over_peak_bytes": mem["per_device_bytes"] / peak})
    if not all(np.isfinite(losses)):
        raise AssertionError(f"dryrun_card: losses {losses}")
    if step_s < ro["compute_s"]:
        raise AssertionError(f"dryrun_card: a step took {step_s} s, under "
                             f"the dry-run's compute_s {ro['compute_s']}")
    if mem["per_device_bytes"] < peak / 2:
        raise AssertionError(f"dryrun_card: predicted "
                             f"{mem['per_device_bytes']} bytes, under half "
                             f"the measured peak {peak}")
    for n in SERVE_PROMPTS:
        measured = MAMBA_PREFILL_S[(SERVE_SLOTS, n)]
        stub = recs[f"{n}_stub"]["roofline"]
        plain = recs[f"{n}_ref"]["roofline"]
        log({"phase": "dryrun_card", "arch": MAMBA_ARCH,
             "prefill": [SERVE_SLOTS, n], "measured_prefill_s": measured,
             "stub_compute_s": stub["compute_s"],
             "stub_memory_s": stub["memory_s"],
             "stub_bound_s": stub["bound_step_time_s"],
             "ref_compute_s": plain["compute_s"],
             "ref_memory_s": plain["memory_s"],
             "ref_bound_s": plain["bound_step_time_s"],
             "measured_over_stub_bound":
             measured / stub["bound_step_time_s"],
             "measured_over_ref_bound":
             measured / plain["bound_step_time_s"]})
        if measured < stub["compute_s"]:
            raise AssertionError(f"dryrun_card: prefill {SERVE_SLOTS}x{n} "
                                 f"took {measured} s, under the stub's "
                                 f"compute_s {stub['compute_s']}")
    log({"phase": "dryrun_card", "wall_s": time.perf_counter() - t_phase})


def main() -> int:
    if not torch.cuda.is_available():
        print("chip_smoke: no CUDA device", file=sys.stderr)
        return 2
    if sys.argv[1:] == [TRAIN_CHILD_FLAG]:
        return train_child(torch.device("cuda"))
    if sys.argv[1:] == [DRYRUN_CHILD_FLAG]:
        return dryrun_child()
    if sys.argv[1:] == [CARD_STEP_CHILD_FLAG]:
        return card_step_child(torch.device("cuda"))
    return run(torch.device("cuda"))


def log_build(built) -> None:
    """One line per source ``build.build_all`` compiled: its ``nvcc``
    seconds, and ptxas's registers and spills."""
    for name, (secs, text) in built.items():
        ptxas = [ln.strip() for ln in text.splitlines()
                 if "registers" in ln or "spill" in ln]
        log({"phase": "build", "source": name, "nvcc_s": secs,
             "ptxas": ptxas})


def run(dev) -> int:
    """All phases on ``dev``; raises on any failure."""
    t_start = time.perf_counter()

    # ---- 1. card ------------------------------------------------------
    smi = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit",
         "--format=csv,noheader"], capture_output=True, text=True,
        check=True, timeout=60).stdout.strip().splitlines()[0]
    log(smi)
    log({"phase": "card", "name": torch.cuda.get_device_name(0),
         "nvidia_smi": smi, "count": torch.cuda.device_count(),
         "torch": torch.__version__, "cuda": torch.version.cuda,
         "python": sys.version.split()[0]})
    # the dispatch and scan kernels now; the fleet engine's two libraries
    # (about a minute of nvcc) build in a thread while phases 2-7 run,
    # and are waited for before phase 8, their first user
    t0 = time.perf_counter()
    fleet_build = concurrent.futures.ThreadPoolExecutor(1).submit(
        build.build_all, FLEET_SOURCES)
    log_build(build.build_all([name for name in build.SIGNATURES
                               if name not in FLEET_SOURCES]))
    log({"phase": "build", "total_s": time.perf_counter() - t0})
    for dtype in k_scan.DTYPE_CODES:
        for aligned in (True, False):
            log({"phase": "build", "kernel": "selective_scan",
                 "dtype": str(dtype), "aligned": aligned,
                 **k_scan.kernel_attributes(dtype, aligned, dev)})

    # ---- 2./3. main path ---------------------------------------------
    tap = Tap(ops)
    cuda_alloc = lambda pol, **kw: VectorizedAllocator(pol, device=dev, **kw)
    numpy_alloc = {"FF": FirstFit, "BF": BestFit}
    simple = {"FIFO": FirstInFirstOut, "SJF": ShortestJobFirst,
              "LJF": LongestJobFirst}
    seth = lambda job: seth_jobs(SETH_JOBS)
    ricc = lambda job: ricc_jobs(job, RICC_JOBS)

    counters.reset_device_launches()
    tap.phase = "seth"
    for sched in ("FIFO", "SJF", "LJF", "EBF"):
        for pol in ("FF", "BF"):
            if sched == "EBF":
                vx = VectorizedEasyBackfilling(cuda_alloc(pol))
                tw = EasyBackfilling(numpy_alloc[pol]())
            else:
                vx = simple[sched](cuda_alloc(pol))
                tw = simple[sched](numpy_alloc[pol]())
            log({"phase": "seth", **run_pair(
                tap, SETH, seth, f"{vx.dispatcher_name}", vx, tw,
                "ebf" if sched == "EBF" else "batched")})
    log({"phase": "seth", **run_pair(
        tap, SETH, seth, "FIFO-vFF-per-job",
        FirstInFirstOut(cuda_alloc("FF", batched=False)),
        FirstInFirstOut(FirstFit()), "per_job")})
    seth_launches = counters.device_launch_stats()
    log({"phase": "seth", "cuda_launches": seth_launches})
    missing = DISPATCH_KERNELS - set(seth_launches)
    if missing:
        raise AssertionError(f"seth: no CUDA launch of {sorted(missing)}")

    tap.phase = "ricc"
    for label, vx, tw, kind in (
            ("vEBF-vBF", VectorizedEasyBackfilling(cuda_alloc("BF")),
             EasyBackfilling(BestFit()), "ebf"),
            ("FIFO-vBF", FirstInFirstOut(cuda_alloc("BF")),
             FirstInFirstOut(BestFit()), "batched"),
            ("FIFO-vFF-per-job",
             FirstInFirstOut(cuda_alloc("FF", batched=False)),
             FirstInFirstOut(FirstFit()), "per_job")):
        log({"phase": "ricc", **run_pair(
            tap, RICC, ricc, label, vx, tw, kind,
            max_events=RICC_MAX_EVENTS, profile=True)})
    launches = counters.device_launch_stats()
    tap.close()
    log({"phase": "main_path", "cuda_launches": launches,
         "ricc_cuda_launches": {k: v - seth_launches.get(k, 0)
                                for k, v in launches.items()}})
    missing = DISPATCH_KERNELS - set(launches)
    if missing:
        raise AssertionError(f"dispatch path: no CUDA launch of "
                             f"{sorted(missing)}")

    # ---- 4. kernels against their plain versions ---------------------
    rng = np.random.default_rng(0)
    table = []
    phase_launches = {
        name: {"seth": seth_launches.get(name, 0),
               "ricc": launches.get(name, 0) - seth_launches.get(name, 0)}
        for name in DISPATCH_KERNELS}

    def seen(name, as_args):
        return {ph: as_args(*tap.inputs[(ph, name)][1])
                for ph in ("seth", "ricc") if (ph, name) in tap.inputs}

    # copies per ops call and their bytes at the RICC peak, against the
    # earlier design's (three H2D copies; fit and score [J, N] back; dense
    # deltas [M, N, R] in)
    avail, cap, req = tap.inputs[("ricc", "alloc_score_batch")][1]
    (n, r), j = np.shape(avail), np.shape(req)[0]
    w = -(-n // 32)
    log({"phase": "transfers", "op": "alloc_score_batch", "J": j, "N": n,
         "R": r, "h2d_bytes": 4 * (2 * n * r + j * r),
         "d2h_bytes": 4 * (j * w + n), "earlier_h2d_copies": 3,
         "earlier_d2h_copies": 2, "earlier_d2h_bytes": 8 * j * n,
         **transfers("alloc_score_batch",
                     lambda: ops.alloc_score_batch(avail, cap, req, dev))})
    avail1, cap1, req1 = tap.inputs[("ricc", "alloc_score")][1]
    log({"phase": "transfers", "op": "alloc_score", "N": n,
         "h2d_bytes": 4 * (2 * n * r + r), "d2h_bytes": 4 * (w + n),
         "earlier_d2h_bytes": 8 * n,
         **transfers("alloc_score",
                     lambda: ops.alloc_score(avail1, cap1, req1, dev))})
    avail2, rel, head = tap.inputs[("ricc", "ebf_shadow_fits")][1]
    m, nnz = rel.times.shape[0], rel.entry_m.shape[0]
    log({"phase": "transfers", "op": "ebf_shadow_fits", "M": m, "N": n,
         "nnz": nnz, "h2d_bytes": 4 * (n * r + r + n + 1 + nnz * (1 + r)),
         "d2h_bytes": 4 * m, "earlier_h2d_copies": 3,
         "earlier_h2d_bytes": 4 * (n * r + m * n * r + r),
         **transfers("ebf_shadow_fits",
                     lambda: ops.ebf_shadow_fits(avail2, rel, head, dev))})

    # alloc_score_batch: (avail, capacity, req [J, R]) -> (bits, score [N])
    extra = [tuple(to_dev(x, dev) for x in floored_system(rng, n, 2, j))
             for n in (1, 31, 32, 33, 129, 1000) for j in (1, 37)]
    extra += [tuple(to_dev(x, dev) for x in floored_system(rng, *nrj))
              for nrj in ((1024, 2, 4097), (4097, 2, 70000), (77, 8, 5))]
    # past the 8 unrolled types: the generic instance
    extra += [tuple(to_dev(x, dev) for x in floored_system(rng, *nrj))
              for nrj in ((33, 9, 37), (1025, 12, 1000), (4097, 16, 3))]
    table.append(kernel_rows(
        "alloc_score_batch", k_alloc.alloc_score_batch,
        ref.alloc_score_packed_ref,
        seen("alloc_score_batch",
             lambda a, c, q: tuple(to_dev(x, dev) for x in (a, c, q))),
        extra, phase_launches["alloc_score_batch"],
        lambda a: (a[2].shape[0],) + tuple(a[0].shape)))

    # alloc_score: (avail, capacity, req [R]) -> (bits [W], score [N])
    extra = []
    for n, r in ((1, 2), (31, 2), (33, 2), (1000, 2), (129, 9), (1000, 12),
                 (33, 16)):
        a, c, q = floored_system(rng, n, r, 1)
        extra.append((to_dev(a, dev), to_dev(c, dev), to_dev(q[0], dev)))
    table.append(kernel_rows(
        "alloc_score", k_alloc.alloc_score, alloc_one_plain,
        seen("alloc_score",
             lambda a, c, q: tuple(to_dev(x, dev) for x in (a, c, q))),
        extra, phase_launches["alloc_score"],
        lambda a: (1,) + tuple(a[0].shape)))

    # ebf_shadow: releases grouped by node -> fits [M]
    extra = []
    for n, r, n_rel, n_times, k_max, low in (
            (40, 2, 30, 3, 6, 0),        # several entries of a node in a group
            (1000, 2, 5, 4, 2, 0),       # nodes with no entries
            (129, 3, 12, 1, 4, 0),       # M = 1
            (50, 2, 25, 6, 4, -3),       # negative deltas
            (10, 2, 0, 1, 3, 0),         # no releases: M = 0
            (300, 2, 40, 10, 4, 0),      # malformed: a group index of M
            (40, 9, 30, 3, 6, -1),       # past the 8 types in registers
            (1500, 12, 400, 50, 6, -1),
            (257, 16, 60, 20, 8, 0),
            (2000, 2, 12000, 6000, 4, -1)):  # M past the shared limit
        a, _, q = floored_system(rng, n, r, 1)
        rel = k_ebf.sparse_releases(n, release_tuples(
            rng, n, r, n_rel, n_times, k_max, low))
        if (n, n_rel) == (300, 40):      # both versions give counts of -1
            rel.entry_m[-1] = rel.times.shape[0]
        extra.append(ebf_args(a, rel, q[0], dev))
    if extra[-1][-1] <= k_ebf.shared_m():
        raise AssertionError("ebf_shadow: no case past the shared limit")
    table.append(kernel_rows(
        "ebf_shadow", k_ebf.ebf_shadow, ref.ebf_shadow_sparse_ref,
        seen("ebf_shadow_fits", lambda a, rl, q: ebf_args(a, rl, q, dev)),
        extra, phase_launches["ebf_shadow"],
        lambda a: (a[5],) + tuple(a[0].shape) + (a[2].shape[0],)))

    # ---- 5.-7. falcon-mamba-7b and smollm-360m serving ---------------
    scan_launches, scan_inputs = serve_mamba(dev)
    serve_routed(dev, "dense_serve", DENSE_ARCH, {}, SERVE_TRAFFIC,
                 SERVE_NEW_TOKENS)
    table.append(check_scan(dev, scan_inputs, scan_launches))
    check_consistency(dev)

    # ---- 5c.-5e. the moe and hybrid families ------------------------
    jamba_launches, jamba_inputs = serve_moe_and_hybrid(dev)

    # ---- 5f.-5g. the vlm and audio families --------------------------
    serve_vlm_and_audio(dev)

    # ---- 15.-16. training (before the fleet phases, after which the
    # profiler records none of this process's kernels), 6b and 6c ----
    scan_child_ms, bwd_child_ms = train_dense_child()
    kernel_rows("selective_scan", k_scan.selective_scan,
                ref.selective_scan_ref, {"jamba_serve": jamba_inputs}, [],
                {"jamba_serve": jamba_launches},
                lambda a: tuple(a[0].shape) + (a[2].shape[1],
                                               a[0].element_size()),
                tol=1e-4, reps=20, plain_reps=2, plain_rounds=3,
                plain_device_reps=2, device=scan_child_ms["jamba_serve"])
    table[-1]["launches"] += jamba_launches
    del jamba_inputs
    scan_train_ms = scan_child_ms["train"]
    train_launches, train_inputs = train_mamba(dev, scan_train_ms,
                                               bwd_child_ms["train"])
    kernel_rows("selective_scan", k_scan.selective_scan,
                ref.selective_scan_ref, {"train": train_inputs}, [],
                {"train": train_launches["selective_scan"]},
                lambda a: tuple(a[0].shape) + (a[2].shape[1],
                                               a[0].element_size()),
                tol=1e-4, reps=20, plain_reps=2, plain_rounds=3,
                plain_device_reps=2, device=scan_train_ms)
    consist, jamba_train_inputs = train_consistency(dev)
    table[-1]["launches"] += train_launches["selective_scan"] + sum(
        c.get("selective_scan", 0) for c in consist.values())
    # ---- 6c. the backward kernel against its plain version -----------
    bwd_launches = {"train": train_launches["selective_scan_bwd"]}
    for name, c in consist.items():
        if c:
            key = "jamba_train" if "jamba" in name else f"{name}_train"
            bwd_launches[key] = c["selective_scan_bwd"]
    table.append(check_scan_bwd(
        dev, {"train": train_inputs, "jamba_train": jamba_train_inputs},
        bwd_launches, bwd_child_ms))
    del train_inputs, jamba_train_inputs
    train_moe(dev)
    train_audio(dev)

    # ---- 8.-11. the fleet engine, 12.-13. the Experiment layer: the
    # host twins of both go to one pool of worker processes first, the
    # fleet's queued before the Experiment's, and run meanwhile --------
    t0 = time.perf_counter()
    log_build(fleet_build.result())
    log({"phase": "build", "sources": FLEET_SOURCES,
         "waited_s": time.perf_counter() - t0})
    cases = plain_cases()
    workers = max(1, min(7, (os.cpu_count() or 2) - 1))
    log({"phase": "fleet", "workers": workers})
    with tempfile.TemporaryDirectory() as td, \
            multiprocessing.get_context("spawn").Pool(workers) as pool:
        pending = fleet_twins(pool, cases)
        exp_pending = experiment_twins(pool, td)
        table.append(fleet(dev, cases, pending))
        exp_launches = experiment(dev, td, exp_pending)
        pool.close()
        pool.join()
    for row in table:
        row["launches"] += exp_launches.get(row["name"], 0)

    # ---- 14. the benchmark modes -------------------------------------
    bench_launches = bench_modes(dev)
    for row in table:
        row["launches"] += bench_launches.get(row["name"], 0)

    # ---- 17. the dry-run against the card ----------------------------
    dryrun_vs_card(dev)
    log({"phase": "bench_metadata", **bench_metadata()})

    log({"phase": "done", "total_s": time.perf_counter() - t_start})
    log(smi)
    log({"kernels": table})
    log({"ok": True, "device": {"platform": "gpu",
                                "kind": torch.cuda.get_device_name(0),
                                "count": torch.cuda.device_count()}})
    return 0


if __name__ == "__main__":
    sys.exit(main())
