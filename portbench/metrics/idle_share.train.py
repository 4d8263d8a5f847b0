"""idle_share.train: the share of a call's wall time in which no kernel or copy runs
on the device, in %: the device's busy time per traced call (the union of
its kernels' and copies' intervals) over the wall time per call of the
untraced window, so that the profiler's own cost on the host is not
counted as idle."""


def read(ctx):
    t = ctx["trace"]
    if t["busy_s"] <= 0:
        return None
    return 100.0 * (1.0 - t["busy_s"] / t["calls"] / ctx["wall_per_call_s"])
