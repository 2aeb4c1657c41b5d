"""What no span of the program names: a stage run's time less the
seconds of the direct children of its span `prune` (the session, the
E-steps, the M-steps, the alternatives, the frequencies, the loss), in
s a stage run."""


def read(ctx):
    try:
        from tokengeex_tpu_torch.utils import trace
    except ImportError:  # a program without the tracer
        return None
    inner = trace.record().child_seconds("prune")
    if not ctx.get("runs") or inner is None:
        return None
    return (ctx["run_s"] - inner) / ctx["runs"]
