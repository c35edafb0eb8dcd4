"""Wall time (ms) per model of ``factorize_model`` less the time in
``ops.linalg.factor_system`` (film info, the low-memory assembly, the hole
vectors and the sweep data), each ended by a synchronization."""


def read(ctx):
    records = [r for r in ctx.factorize if "wall_s" in r]
    if not records:
        return None
    return 1e3 * sum(r["wall_s"] - r["factor_s"] for r in records) / len(records)
