"""Merge's per-pass tables (the pair count's `_encode_setup`: the token
table built and uploaded for the pass's model): the program's span
`merge.count.tables`, in s a stage run."""


def read(ctx):
    try:
        from tokengeex_tpu_torch.utils import trace
    except ImportError:  # a program without the tracer
        return None
    seconds = trace.record().seconds("merge.count.tables")
    if not ctx.get("runs") or seconds is None:
        return None
    return seconds / ctx["runs"]
