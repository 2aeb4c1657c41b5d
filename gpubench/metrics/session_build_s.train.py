"""Session build (train/device_session.py DeviceTrainSession.__init__:
the table, the packing, the caches' set-up): its span, in s a stage
run."""


def read(ctx):
    if not ctx.get("runs") or "gpubench.session" not in ctx["spans"]:
        return None
    return ctx["spans"]["gpubench.session"] / ctx["runs"]
