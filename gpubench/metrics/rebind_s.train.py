"""The session's bindings of a model to its tables (train/device_session.py
_rebind, called by the E-steps, the frequency pass and the alternatives):
every span of the program under `prune` whose last element is `rebind`,
in s a stage run."""


def read(ctx):
    try:
        from tokengeex_tpu_torch.utils import trace
    except ImportError:  # a program without the tracer
        return None
    rec = trace.record()
    paths = [p for p in rec.spans
             if p.startswith("prune.") and p.rsplit(".", 1)[-1] == "rebind"]
    if not ctx.get("runs") or not paths:
        return None
    return sum(rec.seconds(p) for p in paths) / ctx["runs"]
