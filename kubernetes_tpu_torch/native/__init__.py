"""Native (C and CUDA) code of the port: the host replay engine
(replay.c, a copy of kubernetes_tpu/native/replay.c) and build.py, which
compiles it and the CUDA kernels under csrc/ on first use."""
