"""K3's device time in the trace over the pods that took the device
replay route, in microseconds a pick."""

from benchmark import roofline


def read(ctx):
    ns, _n = roofline.kernel_ns(ctx["events"], roofline.K3_SYMBOL)
    if not ns or not ctx["zreplay_pods"]:
        return None
    return ns / 1e3 / ctx["zreplay_pods"]
