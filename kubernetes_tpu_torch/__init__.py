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
                            (policy, copied), the watch wiring and
                            their resolution to an algorithm
                            (factory), the outbound extender
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
  runtime/                  the API objects' JSON and TLV binary codecs
                            (copied; native/_ktlv.c is the TLV codec's C
                            fast path)
  apiserver/, storage/,     the control plane (copied): the apiserver and
  auth/, audit/, apis/,     its stores, authn/authz, audit, component
  telemetry/                config, continuous telemetry
  client/                   the client stack (copied): RESTClient, the
                            local and HTTP transports, reflectors,
                            informers, the FIFO, events, leader election
  scheduler/server.py       SchedulerServer: the daemon that watches an
                            apiserver (ConfigFactory's informers) and
                            schedules on the card
  hyperkube.py              `python -m kubernetes_tpu_torch.hyperkube
                            apiserver | scheduler | extender`
  harness/scenarios.py      cluster and backlog builders shared by the
                            tests and chip_smoke.py
  harness/perf.py           scheduler_perf through the control plane, in
                            one process or across processes (creator.py
                            is the pod-creator process)

It imports torch and never jax, nor anything of kubernetes_tpu.
Integer tables live on the device as int64 (uint32 bitsets widened),
so every score is computed in the reference's int64/float64 arithmetic.
"""

__version__ = "0.1.0"
