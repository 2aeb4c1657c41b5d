"""Host-to-device copies (utils/device.py upload): the bytes a stage run
uploads, counter h2d.bytes, in MB (1e6 bytes) a stage run."""


def read(ctx):
    try:
        from tokengeex_tpu_torch.utils import trace
    except ImportError:  # a program without the tracer
        return None
    nbytes = trace.record().counter("h2d.bytes", "prune")
    if not ctx.get("runs") or nbytes is None:
        return None
    return nbytes / 1e6 / ctx["runs"]
