"""Scheduler: the det time a wave waited for, not hidden behind the
recognition of the wave before (``PageScheduler.timer`` ``det_wait``),
per wave."""


def read(run):
    waves = sum(s.get("waves", 0) for s in run.sched)
    if not waves or not any("det_wait" in s for s in run.sched):
        return None
    return sum(s.get("det_wait", 0.0) for s in run.sched) / waves
