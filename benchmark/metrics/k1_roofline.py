"""K1's share of its roofline: the least time of each launch's (J, N)
sweep (benchmark/roofline.probe_bound_ms), summed, over K1's device time
in the trace."""

from benchmark import roofline


def read(ctx):
    ns, n = roofline.kernel_ns(ctx["events"], roofline.K1_SYMBOL)
    if not ns or not ctx["k1_shapes"]:
        return None
    bound_ms = sum(launches * roofline.probe_bound_ms(J, N)[0]
                   for (J, N, _mode), launches in ctx["k1_shapes"].items())
    return 100.0 * bound_ms / (ns / 1e6)
