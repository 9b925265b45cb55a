"""Event cascade, the mismapper screen: a sample's host seconds in
`realign.resident_pairs`, `realign.screen_resident` and
`realign.accept_resident`, each call ending in a synchronize (hooks.py).
Only the device event path calls them."""

UNIT = "s"
CALLS = ("resident_pairs", "screen_resident", "accept_resident")


def read(run):
    seconds = run.captures.op_seconds if run.captures else {}
    samples = len(run.completed)
    if not samples or not any(name in seconds for name in CALLS):
        return None
    return sum(seconds.get(name, 0.0) for name in CALLS) / samples
