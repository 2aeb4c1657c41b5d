"""Merge's selection (train/merge.py: the loop over the ordered pairs,
their length and allow checks and `add_tokens`): the program's span
`merge.select`, in s a stage run."""


def read(ctx):
    try:
        from tokengeex_tpu_torch.utils import trace
    except ImportError:  # a program without the tracer
        return None
    seconds = trace.record().seconds("merge.select")
    if not ctx.get("runs") or seconds is None:
        return None
    return seconds / ctx["runs"]
