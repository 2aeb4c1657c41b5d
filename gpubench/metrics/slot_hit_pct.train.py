"""The session's cache hits (train/device_session.py e_step and
count_frequencies): the share of row groups served from the slot or seg
cache, 100 groups.cached / (groups.cached + groups.probed), in %."""


def read(ctx):
    try:
        from tokengeex_tpu_torch.utils import trace
    except ImportError:  # a program without the tracer
        return None
    rec = trace.record()
    cached = rec.counter("groups.cached", "prune") or 0
    probed = rec.counter("groups.probed", "prune") or 0
    if not ctx.get("runs") or not cached + probed:
        return None
    return 100.0 * cached / (cached + probed)
