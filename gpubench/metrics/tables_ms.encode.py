"""Tables (ops/match_table.py TokenTable.build and the DeviceTables
upload): phase `tables`, in ms a request."""


def read(ctx):
    if not ctx.get("requests") or "tables" not in ctx["phases"]:
        return None
    return ctx["phases"]["tables"] / ctx["requests"] * 1e3
