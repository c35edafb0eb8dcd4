"""The kind of call ``solve_many``: a sweep of uniform fields against the
model factorized in set-up, on one card or split over data rows of the
cell's cards."""

from benchmark.drives import _Stack


class SolveMany(_Stack):
    """``solve_many`` over ``points_per_call`` uniform fields drawn from
    ``field_mT``, against the model factorized in set-up on the first card.
    With ``data_rows`` in the traffic, each call passes
    ``sharding=batch_sharding(make_mesh(n_data=data_rows, devices=cards))``:
    the points are split over the data rows, each row solves its part
    against its own replica of the factorization, and the results are
    gathered on the first card.  The check is the same either way."""

    def setup(self, st):
        super().setup(st)
        rows = self.traffic.get("data_rows")
        if rows:
            from superscreen_tpu_torch.parallel import batch_sharding, make_mesh

            self.sharding = batch_sharding(make_mesh(n_data=int(rows), devices=self.cards))

    def points(self, params):
        return len(params)

    def draw(self, rng):
        return self.uniform(rng, "field_mT", int(self.traffic["points_per_call"]))

    def call(self, params):
        return self.sweep(params)


ENTRY = SolveMany
