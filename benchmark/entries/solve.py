"""The kind of call ``solve``: one uniform field per call through
``solve()``, against the model factorized in set-up."""

import numpy as np

from benchmark.drives import _Stack


class Solve(_Stack):
    """``solve`` of one uniform field drawn from ``field_mT``; the last
    round's streams are kept."""

    def points(self, params):
        return 1

    def draw(self, rng):
        return self.uniform(rng, "field_mT", 1)

    def call(self, params):
        c = self.config
        solutions = self.st.solve(
            model=self.model, applied_field=self.st.sources.ConstantField(float(params[0])),
            field_units=c["field_units"], iterations=c["iterations"], coupling=c["coupling"],
            progress_bar=False, torch_device=self.torch_device,
        )
        return {name: np.array(fs.stream)[None] for name, fs in solutions[-1].film_solutions.items()}


ENTRY = Solve
