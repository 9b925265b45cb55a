"""The chimeric fragments the generator wrote into a sample, summed over
every sample completed in the window, over the time from the window's
start to the end of the last sample."""

UNIT = "fragments/s"


def read(run):
    done = len(run.completed)
    seconds = run.window_end - run.window_start
    if not done or seconds <= 0:
        return None
    return done * run.fragments / seconds
