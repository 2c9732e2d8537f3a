"""Share of the traced window in which no device event (kernel, copy or
set) ran: 1 - (their union) / the window."""


def read(ctx):
    if not ctx["events"] or not ctx["window_s"]:
        return None
    return 100.0 * (1.0 - ctx["busy_ns"] / 1e9 / ctx["window_s"])
