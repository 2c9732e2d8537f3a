"""Share of the window's wall in the program's `encode` phase (dedup,
snapshot encode, node-axis pad), exclusive of the phases under it."""


def read(ctx):
    if not ctx["window_s"] or not ctx["phases"]:
        return None
    return 100.0 * ctx["phases"].get("encode", 0.0) / ctx["window_s"]
