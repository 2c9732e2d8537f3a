"""Predicate masks, priority scores and host selection on tensors.

The PyTorch counterparts of kubernetes_tpu/ops: the same function names,
one pending pod against all N nodes at once, on whatever device the
tensors lie. Integer tables are int64 (bitsets widened from uint32), so
the arithmetic is the reference's int64/float64 arithmetic; every
promotion is explicit. probe_kernel.py wraps the hand-written CUDA
kernel of the wave probe's resource sweep, zreplay_kernel.py that of the
zoned pick loop, preempt_kernel.py that of the preemption victim scorer
(preempt.py holds its plain version and the director's VictimScorer);
services.py holds the ServiceAffinity / ServiceAntiAffinity functions of
Policy files.
"""
