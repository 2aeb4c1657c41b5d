"""Merge's chained encode (the pair count's samples past the pack width:
fixed-width windows, their backpointers walked on the host): the
program's span `merge.count.chained`, in s a stage run."""


def read(ctx):
    try:
        from tokengeex_tpu_torch.utils import trace
    except ImportError:  # a program without the tracer
        return None
    seconds = trace.record().seconds("merge.count.chained")
    if not ctx.get("runs") or seconds is None:
        return None
    return seconds / ctx["runs"]
