"""Wall time (ms) per model in ``ops.linalg.factor_system`` (the
factorization route), each call ended by a synchronization."""


def read(ctx):
    records = [r for r in ctx.factorize if "wall_s" in r]
    if not records:
        return None
    return 1e3 * sum(r["factor_s"] for r in records) / len(records)
