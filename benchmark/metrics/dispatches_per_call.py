"""Dispatches of the wave driver (models/wave.py's tally: probe,
group_probe, zreplay, zreplay_group, apply, scan) a call."""


def read(ctx):
    if not ctx["calls"]:
        return None
    return sum(ctx["dispatches"].values()) / ctx["calls"]
