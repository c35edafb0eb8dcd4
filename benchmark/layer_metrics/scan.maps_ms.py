"""Wall time (ms) of ``squids.scanning.applied_field_maps`` per scan,
between two synchronizations."""


def read(ctx):
    walls = ctx.wall_s.get("scan_maps")
    if not walls:
        return None
    return 1e3 * sum(walls) / len(walls)
