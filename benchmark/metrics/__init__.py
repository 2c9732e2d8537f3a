"""Per-layer metric readers, one file a metric, loaded by name from
run.py. Each defines read(ctx) -> the value, or None where the window
gave it nothing to read. ctx holds:

- window_s, calls, pods: the window's wall seconds, calls and pods placed;
- phases: exclusive seconds of each trace/profile phase over the window;
- dispatches: the wave driver's dispatches over the window, by route
  (the tallies that count pods left out);
- k1, k3: launches the kernel wrappers counted; k1_shapes {(J, N, mode):
  launches}, k3_shapes {(N, K, zones): launches};
- zreplay_pods: pods that took the device replay (None where a call
  mixed routes); node_picks: the sum over the window's picks of the
  nodes that fit at each, as the reference counts them;
- events: [(name, start ns, end ns)] of every device event traced;
  busy_ns: the time covered by at least one of them.
"""
