"""The frequency pass's chained encode (train/device_session.py
count_frequencies: samples past the encode width, their windows'
backpointers walked on the host): the program's span
`prune.frequencies.chained`, in s a stage run."""


def read(ctx):
    try:
        from tokengeex_tpu_torch.utils import trace
    except ImportError:  # a program without the tracer
        return None
    seconds = trace.record().seconds("prune.frequencies.chained")
    if not ctx.get("runs") or seconds is None:
        return None
    return seconds / ctx["runs"]
