"""The session's tables (train/device_session.py DeviceTrainSession.__init__:
TokenTable.build, the rank space, the first binding's upload): the
program's span `prune.session.tables`, in s a stage run."""


def read(ctx):
    try:
        from tokengeex_tpu_torch.utils import trace
    except ImportError:  # a program without the tracer
        return None
    seconds = trace.record().seconds("prune.session.tables")
    if not ctx.get("runs") or seconds is None:
        return None
    return seconds / ctx["runs"]
