"""Model layer (models/recsys.py bulk_forward): the median host time of a
pass from the call to its return, before the scores are read (which waits
for the device), in ms: the host's share of a pass.  Taken over the passes
after the traced part, which pay the profiler's host cost."""


def read(run):
    return run.percentile_ms("dispatch_s", 50)
