"""K3's share of its roofline: the least time of each launch
(benchmark/roofline.zreplay_bound_ms: the bytes from (N, K), the
operations from the nodes that fit at each pick, as the reference counts
them), summed, over K3's device time in the trace. The window's node
picks are spread evenly over its launches; the operations term is linear
in them."""

from benchmark import roofline


def read(ctx):
    ns, n = roofline.kernel_ns(ctx["events"], roofline.K3_SYMBOL)
    launches = sum(ctx["k3_shapes"].values())
    if not ns or not launches or not ctx["node_picks"]:
        return None
    picks = ctx["node_picks"] / launches
    bound_ms = sum(k * roofline.zreplay_bound_ms(N, K, picks)[0]
                   for (N, K, _zones), k in ctx["k3_shapes"].items())
    return 100.0 * bound_ms / (ns / 1e6)
