"""Share (%) of the least time of the film solves (the stored factors read
once per solve, ``A`` once per refinement residual) in the device time
under the ``bench.film_solve`` span (``sweep._solve_film_batch``)."""

from benchmark.readers import roofline


def read(ctx):
    return roofline(ctx, "bench.film_solve")
