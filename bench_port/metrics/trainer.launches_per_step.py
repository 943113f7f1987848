"""Device kernels a training step launches: the kernels of the traced
window (copies and sets left out) over its steps."""
UNIT = "launches"


def read(ctx):
    if ctx["kind"] != "train" or not ctx.get("steps"):
        return None
    n = sum(1 for name, _, _ in ctx["trace"].device
            if not name.startswith(("Memcpy", "Memset")))
    return n / ctx["steps"] if n else None
