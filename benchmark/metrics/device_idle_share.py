"""Device (one H100): the share of the traced window in which no kernel,
copy or set ran on the card, from the profiler's trace."""

UNIT = "%"


def read(run):
    profile = run.profile
    if profile is None or not profile.ops or profile.window_s <= 0:
        return None
    return 100.0 * (1.0 - profile.busy_s / profile.window_s)
