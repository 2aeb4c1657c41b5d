"""Front end of encode (core/tokenizer.py: the span layout, str to bytes,
the stitch): a request's host-clock time less its PhaseTimer phases, in
ms a request."""


def read(ctx):
    if not ctx.get("requests"):
        return None
    inner = sum(ctx["phases"].values())
    return (ctx["request_s"] - inner) / ctx["requests"] * 1e3
