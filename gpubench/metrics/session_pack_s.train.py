"""The session's packing (train/device_session.py DeviceTrainSession.__init__:
the pack width and pack_samples over the EM snippets): the program's
span `prune.session.pack`, in s a stage run."""


def read(ctx):
    try:
        from tokengeex_tpu_torch.utils import trace
    except ImportError:  # a program without the tracer
        return None
    seconds = trace.record().seconds("prune.session.pack")
    if not ctx.get("runs") or seconds is None:
        return None
    return seconds / ctx["runs"]
