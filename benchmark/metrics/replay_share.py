"""Share of the window's wall in the program's `replay` phase (the
device replay and its fold, models/zreplay.py)."""


def read(ctx):
    if not ctx["window_s"] or not ctx["phases"]:
        return None
    return 100.0 * ctx["phases"].get("replay", 0.0) / ctx["window_s"]
