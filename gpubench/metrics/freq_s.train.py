"""The frequency passes (DeviceTrainSession.count_frequencies: the
Viterbi scan and the walk in count mode), around _count_frequencies: in
s a stage run."""


def read(ctx):
    if not ctx.get("runs") or "gpubench.frequencies" not in ctx["spans"]:
        return None
    return ctx["spans"]["gpubench.frequencies"] / ctx["runs"]
