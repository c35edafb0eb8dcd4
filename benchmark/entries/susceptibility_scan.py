"""The kind of call ``susceptibility_scan``: one scan line of a scanning
SQUID over a sample, through ``squids.scanning.susceptibility_scan``."""

from typing import List

import numpy as np

from benchmark.devices import build_device
from benchmark.drives import Check, Entry
from benchmark.reference import films as ref
from benchmark.reference.config import MU_0, PHI_0, film_meshes
from benchmark.reference.mesh import circle, closed_ccw


class SusceptibilityScan(Entry):
    """``squids.scanning.susceptibility_scan`` of the sample model
    factorized in set-up, the SQUID solved in set-up: ``positions`` points
    on a line across ``x_um`` at a lateral offset drawn from ``y_um``.  The
    check compares the susceptibility at every position of each sampled
    scan."""

    def setup(self, st):
        from superscreen_tpu_torch.squids import scanning

        self.st, self.scanning = st, scanning
        c = self.config
        squid = build_device(st, "squid", c["devices"]["squid"], c["solve_dtype"])
        sample = build_device(st, "sample", c["devices"]["sample"], c["solve_dtype"])
        self.squid_solution = st.solve(
            squid, applied_field=st.sources.ConstantField(0), circulating_currents=dict(c["squid_currents"]),
            field_units="mT", current_units=c["squid_current_units"], progress_bar=False,
            torch_device=self.torch_device,
        )[-1]
        self.model = st.factorize_model(device=sample, current_units=c["current_units"], torch_device=self.torch_device)

    def positions(self, y):
        B = int(self.traffic["positions"])
        return np.column_stack([np.linspace(*self.traffic["x_um"], B), np.full(B, float(y))])

    def points(self, params):
        return int(self.traffic["positions"])

    def draw(self, rng):
        return float(self.uniform(rng, "y_um"))

    def call(self, params):
        c = self.config
        return np.array(self.scanning.susceptibility_scan(
            sample_model=self.model, squid_solution=self.squid_solution, positions=self.positions(params),
            squid_height=c["squid_height"], pickup_loop=c["pickup_loop"], I_fc=c["I_fc_A"],
            iterations=c["iterations"], back_action=c["back_action"], coupling=c["coupling"],
            torch_device=self.torch_device,
        ))

    def reference_scan(self, ys, prec, device) -> List[np.ndarray]:
        """The response map (Phi_0 / A) at each offset in ``ys``."""
        c = self.config
        squid_spec = c["devices"]["squid"]
        (squid_film,) = film_meshes(squid_spec)
        (sample_film,) = film_meshes(c["devices"]["sample"])
        squid, J = ref.squid_current(squid_film, c["squid_currents"], prec, device)
        sample = ref.FilmSystem(sample_film, prec, device)
        loop = next(p for p in squid_spec["abstract_regions"] + squid_spec["holes"] if p["name"] == c["pickup_loop"])
        layers = {l["name"]: l for l in squid_spec["layers"]}
        contour = closed_ccw(circle(*loop["circle"]))
        # Squid currents in the sample's current units (both length units um).
        scale = {"mA": 1e3, "uA": 1.0}[c["squid_current_units"]] / {"mA": 1e3, "uA": 1.0}[c["current_units"]]
        unit = {"mA": 1e-3, "uA": 1e-6}[c["current_units"]]
        out = []
        for y in ys:
            flux = ref.scan_response(
                squid, J, sample, self.positions(y), c["squid_height"], contour,
                float(layers[loop["layer"]]["z0"]), scale,
            ).numpy()
            out.append(flux * MU_0 * unit * 1e-6 / c["I_fc_A"] / PHI_0)
        return out

    @staticmethod
    def scan_error(M, want) -> float:
        return float(np.abs(M - want).max() / np.abs(want).max())

    def check(self, kept, device) -> List[Check]:
        refs = self.reference_scan([y for y, _ in kept], ref.F64, device)
        err = max((self.scan_error(M, want) for (_, M), want in zip(kept, refs)), default=float("nan"))
        return [Check("susceptibility_rel_err", err, self.config["limits"]["susceptibility_rel_err"])]

    def control(self, draws, device) -> List[float]:
        refs = self.reference_scan(draws, ref.F64, device)
        ctrl = self.reference_scan(draws, ref.TF32, device)
        return [self.scan_error(M, want) for M, want in zip(ctrl, refs)]


ENTRY = SusceptibilityScan
