"""The session's E-steps (DeviceTrainSession.e_step: the probe or the
regather, the scans, the segsum, the fold), around run_e_step: in s a
stage run."""


def read(ctx):
    if not ctx.get("runs") or "gpubench.e_step" not in ctx["spans"]:
        return None
    return ctx["spans"]["gpubench.e_step"] / ctx["runs"]
