"""kubernetes_tpu_torch — the PyTorch/CUDA port of kubernetes_tpu.

The greedy single-device wave scheduler of kubernetes_tpu, from Pod/Node
objects to node names, in PyTorch for an NVIDIA H100. Every module
mirrors the path of its counterpart in kubernetes_tpu, and every
decision is bit-identical to it and to the serial oracle.

Layout:
  api/, oracle/, snapshot/  host copies of the JAX package's modules
                            (numpy and stdlib only; snapshot/carry.py
                            places an encoded snapshot on a device)
  native/                   the host replay engine (replay.c) and the
                            on-demand builds of the port's native code
  ops/                      predicate, priority and selection functions
                            on tensors; ops/probe_kernel.py,
                            zreplay_kernel.py and preempt_kernel.py wrap
                            the hand-written CUDA kernels (csrc/)
  models/                   the serial scan (batch), the wave probe
                            (probe), the host replay (replay), the
                            device replay (zreplay) and the wave driver
                            (wave)
  scheduler/algorithm.py    TorchScheduleAlgorithm: pods + cluster
                            state -> node names; with a cache, the
                            daemon mode (incremental snapshot, resident
                            device tables, warmup)
  scheduler/                the scheduling core (cache, core, copied:
                            the scheduler cache and the scheduleOne
                            loop), the provider registry (plugins,
                            copied; algorithmprovider), Policy files
                            (policy, copied), their resolution to an
                            algorithm (factory), the outbound extender
                            (extender, copied), the inbound
                            scheduler-extender service (extender_server)
                            and the gang director with priority
                            preemption (gang)
  snapshot/incremental.py   the incremental encoder (copied): the node
                            tables patched per cache event
  metrics/                  the scheduler's counters (copied)
  utils/, analysis/, trace/ the host utilities (clocks, work queues, flow
                            control, the step tracer), the race and
                            lock-order sanitizers and the span and
                            phase-timer layer the core calls (copied;
                            analysis/__init__.py and trace/profile.py
                            keep what the port can run)
  runtime/                  the API objects' JSON codec (copied)
  hyperkube.py              `python -m kubernetes_tpu_torch.hyperkube
                            extender`
  harness/scenarios.py      cluster and backlog builders shared by the
                            tests and chip_smoke.py

It imports torch and never jax, nor anything of kubernetes_tpu.
Integer tables live on the device as int64 (uint32 bitsets widened),
so every score is computed in the reference's int64/float64 arithmetic.
"""

__version__ = "0.1.0"
