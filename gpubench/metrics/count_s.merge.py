"""Merge's pair count (train/estep_device.py count_pairs_arrays: the
pass's tables, the device encode, the walk and the pair table): the
program's span `merge.count`, in s a stage run."""


def read(ctx):
    try:
        from tokengeex_tpu_torch.utils import trace
    except ImportError:  # a program without the tracer
        return None
    seconds = trace.record().seconds("merge.count")
    if not ctx.get("runs") or seconds is None:
        return None
    return seconds / ctx["runs"]
