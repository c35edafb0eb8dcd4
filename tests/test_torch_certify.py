"""The port's float64 certification and polish (``certify_sweep``,
``refine_sweep_f64``, ``solve_many(final_refine=...)``) against
``superscreen_tpu.certify`` on the float32 two-ring model of
``tests/test_certify.py``, on the CPU.

Two kinds of comparison.  With the JAX package's own systems handed to the
port (same ``A``, same streams: :func:`_shared_data`), every report key
that does not depend on a solver's rounding must agree to 1e-6 relative.
With each package on its own assembly of the same mesh the float32 systems
differ in their last bits, so streams agree only at the float32 level, and
the bars of the JAX tests are applied to the port's own numbers."""

import numpy as np
import pytest
import torch

import superscreen_tpu as sc
import superscreen_tpu.geometry as geo
import superscreen_tpu_torch as st
from superscreen_tpu import certify as ref_certify
from superscreen_tpu.sweep import _film_sweep_data, _run_sweep
from superscreen_tpu.sweep import solve_many as ref_solve_many
from superscreen_tpu_torch import certify
from superscreen_tpu_torch import sweep as port_sweep
from superscreen_tpu_torch.ops import linalg
from superscreen_tpu_torch.solver import utils as port_utils

torch.set_num_threads(2)

VORTEX_FLUX = 1645.5
# Same systems and streams on both sides, residuals formed in float64 in
# another order: a relative residual of ~1e-6 then agrees to ~1e-7.
KEY_RTOL = 1e-6


def _two_rings(dtype="float32"):
    layers = [sc.Layer("layer0", Lambda=1, z0=0), sc.Layer("layer1", Lambda=1, z0=1)]
    films = [
        sc.Polygon("big_ring", layer="layer0", points=geo.circle(7.5, points=80)),
        sc.Polygon("little_ring", layer="layer1", points=geo.circle(5, points=60)),
    ]
    holes = [
        sc.Polygon("big_hole", layer="layer0", points=geo.circle(3.75, points=40)),
        sc.Polygon("little_hole", layer="layer1", points=geo.circle(2.5, points=30)),
    ]
    device = sc.Device("two_rings", layers=layers, films=films, holes=holes, solve_dtype=dtype)
    device.make_mesh(max_edge_length=0.9)
    return device


def _mini_strip():
    """The terminal strip of tests/test_certify.py."""
    device = sc.Device(
        "mini_strip",
        layers=[sc.Layer("base", Lambda=0.8)],
        films=[sc.Polygon("strip", layer="base", points=geo.box(4.0, 8.0, points=81))],
        terminals={
            "strip": [
                sc.Polygon("source", points=geo.box(4.0, 0.08, center=(0, 4.0))),
                sc.Polygon("drain", points=geo.box(4.0, 0.08, center=(0, -4.0))),
            ]
        },
        length_units="um",
        solve_dtype="float32",
    )
    device.make_mesh(max_edge_length=0.5)
    return device


def _sweep_inputs(data, B, circ=0.0):
    """The inputs of tests/test_certify.py: fields rising with the sweep
    point and one circulating current in every hole."""
    Hz = {
        name: np.linspace(0.2, 1.0, B)[:, None].astype(np.float32)
        * np.ones(d.n, dtype=np.float32)[None, :]
        for name, d in data.items()
    }
    I_circ = {
        name: np.full((B, len(d.hole_names)), circ, dtype=np.float32) for name, d in data.items()
    }
    return Hz, I_circ


def _t(a):
    return None if a is None else torch.as_tensor(np.array(a))


def _shared_data(ref_data):
    """The port's FilmSweepData around the JAX package's own arrays (system,
    index set, hole and transport offsets, vortex columns), LU-factorized
    by the port; the gradient and self-field operators are not needed by
    the certification and stay empty."""
    out = {}
    for name, d in ref_data.items():
        nv = int(np.asarray(d.n_valid))
        A = None if d.A is None else _t(d.A)[:nv, :nv].contiguous()
        factors = None if A is None else linalg.factor_system(A)
        empty = torch.zeros((0, 1))
        out[name] = port_sweep.FilmSweepData(
            name=name, n=int(d.n), interior=_t(d.interior)[:nv].long(), factors=factors, A=A,
            Qw=None, weights=_t(d.weights), gx_idx=empty.long(), gx_w=empty, gy_idx=empty.long(),
            gy_w=empty, sites=_t(d.sites), z0=float(d.z0), hole_masks=_t(d.hole_masks),
            hole_ha_vecs=_t(d.hole_ha_vecs), hole_names=list(d.hole_names),
            fac_kind="lu" if A is not None else "cg",
            vortex_cols=None if d.vortex_cols is None else _t(d.vortex_cols)[:nv],
            terminal=bool(d.terminal), g_offset=_t(d.g_offset), ha_offset=_t(d.ha_offset),
        )
    return out


@pytest.fixture(scope="module")
def ref_device():
    return _two_rings()


@pytest.fixture(scope="module")
def shared(ref_device):
    """A finished JAX sweep (B = 3, two coupling rounds, circulating
    currents) with its film data, and the port's film data around the same
    systems."""
    model = sc.factorize_model(device=ref_device, current_units="uA")
    data = {name: _film_sweep_data(model, name) for name in ref_device.films}
    Hz, I_circ = _sweep_inputs(data, B=3, circ=5.0)
    streams, _, _, others = _run_sweep(data, Hz, I_circ, VORTEX_FLUX, 2, 2)
    streams = {k: np.asarray(v) for k, v in streams.items()}
    others = {k: np.asarray(v) for k, v in others.items()}
    return dict(ref_data=data, data=_shared_data(data), Hz=Hz, I_circ=I_circ,
                streams=streams, others=others)


@pytest.fixture(scope="module")
def reports(shared):
    args = (shared["streams"], shared["others"], shared["Hz"])
    ref = ref_certify.certify_sweep(
        shared["ref_data"], *args, I_circ=shared["I_circ"], n_sample_rows=64
    )
    port = certify.certify_sweep(shared["data"], *args, I_circ=shared["I_circ"], n_sample_rows=64)
    return ref, port


def test_certify_sweep_returns_the_reference_keys(reports):
    ref, port = reports
    assert set(port) == set(ref)
    assert port["films_certified"] == ref["films_certified"]
    assert port["n_sample_rows"] == ref["n_sample_rows"] == 64
    assert set(port["film_seconds"]) == set(ref["film_seconds"])


@pytest.mark.parametrize("film", ["big_ring", "little_ring"])
def test_certify_sweep_residuals_match_jax(reports, film):
    ref, port = reports
    # Rounded to four digits in both reports.
    np.testing.assert_allclose(
        port["residual_rel_per_film"][film], ref["residual_rel_per_film"][film], rtol=2e-3
    )
    assert len(port["residual_rel_per_film"][film]) == 3


def test_certify_sweep_residual_max_matches_jax(reports):
    ref, port = reports
    assert 0 < port["residual_rel_max"] < 1e-5
    np.testing.assert_allclose(port["residual_rel_max"], ref["residual_rel_max"], rtol=KEY_RTOL)


def test_certify_sweep_sampled_rows_agree_with_the_host(reports):
    ref, port = reports
    # The JAX test's bar: device float64 against NumPy float64.
    assert port["sampled_row_rel_disagreement"] < 1e-12
    assert ref["sampled_row_rel_disagreement"] < 1e-12


def test_certify_sweep_refinement_keys(reports):
    ref, port = reports
    # The refined streams end at each solver's own float64 floor; the
    # distance of the float32 streams to them is a ~1e-6 number that both
    # report alike to three digits.
    assert port["refined_residual_rel_max"] < 1e-9
    assert port["refined_residual_rel_max"] <= port["residual_rel_max"]
    np.testing.assert_allclose(
        port["refined_stream_delta_max"], ref["refined_stream_delta_max"], rtol=1e-3
    )
    assert port["refined_stream_delta_max"] < 1e-4


@pytest.mark.parametrize("result_dtype", [None, "float64"])
def test_refine_sweep_f64_matches_jax(shared, result_dtype):
    args = (shared["streams"], shared["others"], shared["Hz"])
    kwargs = dict(I_circ=shared["I_circ"], steps=2, result_dtype=result_dtype)
    ref_polished, ref_report = ref_certify.refine_sweep_f64(shared["ref_data"], *args, **kwargs)
    polished, report = certify.refine_sweep_f64(shared["data"], *args, **kwargs)
    assert set(report) == set(ref_report) and report["steps"] == 2
    np.testing.assert_allclose(
        report["residual_rel_max_before"], ref_report["residual_rel_max_before"], rtol=KEY_RTOL
    )
    # The JAX test's bar for the polished iterate.
    assert report["residual_rel_max_after"] < 1e-9
    assert report["residual_rel_max_after"] < report["residual_rel_max_before"]
    for name, g in polished.items():
        ref_g = np.asarray(ref_polished[name])
        assert g.numpy().dtype == ref_g.dtype == (np.float64 if result_dtype else np.float32)
        # Both polish the same float32 system to its float64 solution; a
        # float32 delivery rounds it at 6e-8.
        tol = 1e-9 if result_dtype else 2e-7
        assert np.abs(g.numpy() - ref_g).max() <= tol * np.abs(ref_g).max()
        before = report["per_film"][name]["residual_rel_before"]
        np.testing.assert_allclose(
            before, ref_report["per_film"][name]["residual_rel_before"], rtol=2e-3
        )
    # The delivered float64 arrays certify at the polish floor, the
    # float32 ones at the float32 representation floor.
    check = certify.certify_sweep(
        shared["data"], polished, shared["others"], shared["Hz"], I_circ=shared["I_circ"],
        refine_steps=0, n_sample_rows=8,
    )
    assert check["residual_rel_max"] < (1e-8 if result_dtype else 1e-6)


def test_certify_respects_budget(shared):
    report = certify.certify_sweep(
        shared["data"], shared["streams"], shared["others"], shared["Hz"],
        I_circ=shared["I_circ"], budget_s=0.0, n_sample_rows=0,
    )
    assert report["films_certified"] == ["big_ring"]
    assert "budget_note" in report and "1/2 films" in report["budget_note"]
    assert report["sampled_row_rel_disagreement"] == 0.0


def test_certify_and_polish_skip_vortex_films(ref_device):
    model = sc.factorize_model(
        device=ref_device, current_units="uA",
        vortices=[sc.Vortex(x=5.5, y=0.0, film="big_ring")],
    )
    ref_data = {name: _film_sweep_data(model, name) for name in ref_device.films}
    Hz, I_circ = _sweep_inputs(ref_data, B=2)
    streams, _, _, others = _run_sweep(ref_data, Hz, I_circ, VORTEX_FLUX, 1, 2)
    streams = {k: np.asarray(v) for k, v in streams.items()}
    data = _shared_data(ref_data)
    ref = ref_certify.certify_sweep(ref_data, streams, others, Hz, I_circ=I_circ, n_sample_rows=8)
    port = certify.certify_sweep(data, streams, others, Hz, I_circ=I_circ, n_sample_rows=8)
    assert port["films_skipped"] == ref["films_skipped"]
    assert port["films_certified"] == ref["films_certified"] == ["little_ring"]
    polished, report = certify.refine_sweep_f64(data, streams, others, Hz, I_circ=I_circ)
    _, ref_report = ref_certify.refine_sweep_f64(ref_data, streams, others, Hz, I_circ=I_circ)
    assert report["per_film"]["big_ring"] == ref_report["per_film"]["big_ring"]
    np.testing.assert_array_equal(polished["big_ring"].numpy(), streams["big_ring"])


def test_certify_and_polish_skip_matrix_free_films(monkeypatch):
    monkeypatch.setattr(port_utils, "MAX_DENSE_KERNEL_SIZE", 10)
    monkeypatch.setenv("SUPERSCREEN_TPU_LARGE_FACTOR", "cg")
    device = st.device_from_reference(_two_rings())
    result = st.solve_many(
        device, applied_fields=[st.sources.ConstantField(0.5)], iterations=1, final_refine=1,
        torch_device="cpu",
    )
    assert all(d.fac_kind == "cg" for d in result.model.film_data.values())
    assert result.final_refine_report["per_film"] == {
        "big_ring": "matrix-free film: skipped", "little_ring": "matrix-free film: skipped"
    }
    data = result.model.film_data
    Hz, I_circ = _sweep_inputs(data, B=1)
    report = certify.certify_sweep(
        data, {k: v.astype(np.float32) for k, v in result.streams.items()}, None, Hz, I_circ
    )
    assert report["films_certified"] == []
    assert set(report["films_skipped"]) == {"big_ring", "little_ring"}
    assert "matrix-free" in report["films_skipped"]["big_ring"]


def test_terminal_film_offsets_enter_the_certified_system():
    """A film with terminals carries stream and effective-field offsets;
    with the JAX package's system they must give the JAX residual."""
    ref_device = _mini_strip()
    model = sc.factorize_model(
        device=ref_device, current_units="mA",
        terminal_currents={"strip": {"source": "1 mA", "drain": "-1 mA"}},
    )
    ref_data = {"strip": _film_sweep_data(model, "strip")}
    assert ref_data["strip"].g_offset is not None
    Hz, I_circ = _sweep_inputs(ref_data, B=2)
    streams, _, _, _ = _run_sweep(ref_data, Hz, I_circ, VORTEX_FLUX, 0, 2)
    streams = {k: np.asarray(v) for k, v in streams.items()}
    ref = ref_certify.certify_sweep(ref_data, streams, None, Hz, n_sample_rows=8)
    port = certify.certify_sweep(_shared_data(ref_data), streams, None, Hz, n_sample_rows=8)
    assert 0 < port["residual_rel_max"] < 1e-4
    np.testing.assert_allclose(port["residual_rel_max"], ref["residual_rel_max"], rtol=KEY_RTOL)
    assert port["sampled_row_rel_disagreement"] < 1e-12


@pytest.fixture(scope="module")
def polished_sweeps(ref_device):
    """solve_many(final_refine=2) of both packages, each on its own
    float32 assembly of the same mesh."""
    fields = [0.5, 1.0]
    ref = ref_solve_many(
        device=ref_device, applied_fields=[sc.sources.ConstantField(v) for v in fields],
        field_units="mT", iterations=1, final_refine=2, coupling="exact",
    )
    result = st.solve_many(
        st.device_from_reference(ref_device),
        applied_fields=[st.sources.ConstantField(v) for v in fields],
        field_units="mT", iterations=1, final_refine=2, torch_device="cpu",
    )
    return ref, result


@pytest.mark.parametrize("quantity", ["streams", "current_densities", "self_fields"])
def test_solve_many_final_refine_matches_jax(polished_sweeps, quantity):
    ref, result = polished_sweeps
    # Each package polishes its own float32-rounded system to float64: the
    # two assemblies differ in the last bits of A (6e-8 per entry), which
    # the systems' conditioning carries into the streams (measured 2e-7;
    # 5e-7 in the self-fields, whose operator is float32 on both sides).
    tol = 5e-6 if quantity == "self_fields" else 2e-6
    for name, a in getattr(ref, quantity).items():
        b = getattr(result, quantity)[name]
        assert b.dtype == np.float64 and np.asarray(a).dtype == np.float64
        assert np.abs(b - np.asarray(a)).max() <= tol * np.abs(a).max(), (quantity, name)


def test_solve_many_final_refine_report_and_delivery(polished_sweeps):
    ref, result = polished_sweeps
    report = result.final_refine_report
    assert set(report) == set(ref.final_refine_report)
    # The JAX test's bar.
    assert report["residual_rel_max_after"] < 1e-9
    assert report["residual_rel_max_before"] < 1e-5
    # The delivered float64 arrays still satisfy the per-film systems.
    model = result.model
    conv = port_utils.field_conversion_factor(
        "mT", model.current_units, length_units=model.device.length_units, ureg=model.device.ureg
    ).magnitude
    Hz = {k: (v * conv).astype(np.float32) for k, v in result.applied_fields.items()}
    others = {k: (v * conv).astype(np.float32) for k, v in result.other_fields.items()}
    check = certify.certify_sweep(
        model.film_data, result.streams, others, Hz, refine_steps=0, n_sample_rows=8
    )
    assert check["residual_rel_max"] < 1e-6
    # J follows the polished streams.
    Js, _ = certify.sweep_outputs_from_streams(model.film_data, result.streams)
    for name, J in Js.items():
        np.testing.assert_allclose(J.numpy(), result.current_densities[name], rtol=0, atol=1e-12)


def test_solve_many_final_refine_float32_delivery_and_history_error(ref_device):
    device = st.device_from_reference(ref_device)
    fields = [st.sources.ConstantField(0.5)]
    result = st.solve_many(
        device, applied_fields=fields, iterations=1, final_refine=1, result_dtype="float32",
        torch_device="cpu",
    )
    for arrays in (result.streams, result.current_densities, result.self_fields):
        assert all(a.dtype == np.float32 for a in arrays.values())
    assert result.final_refine_report["steps"] == 1
    plain = st.solve_many(device, applied_fields=fields, iterations=1, torch_device="cpu")
    assert plain.final_refine_report is None
    with pytest.raises(ValueError, match="keep_history"):
        st.solve_many(
            device, applied_fields=fields, iterations=1, final_refine=1, keep_history=True,
            torch_device="cpu",
        )


def test_float64_model_certifies_at_the_float64_floor(ref_device):
    """The reconstruction of the right-hand side mirrors the solve exactly:
    on a float64 model the certified residual is rounding only."""
    device = st.device_from_reference(ref_device)
    device.solve_dtype = "float64"
    model = st.factorize_model(
        device=device, current_units="uA", circulating_currents={"big_hole": 5.0},
        torch_device="cpu",
    )
    data = model.film_data
    B = 2
    Hz = {n: torch.as_tensor(np.linspace(0.2, 1.0, B)[:, None] * np.ones(d.n)) for n, d in data.items()}
    I_circ = {
        n: torch.tensor([[5.0 if h == "big_hole" else 0.0 for h in d.hole_names]] * B,
                        dtype=torch.float64)
        for n, d in data.items()
    }
    streams, _, _, others = port_sweep._run_sweep(data, Hz, I_circ, VORTEX_FLUX, 2, 2)
    report = certify.certify_sweep(data, streams, others, Hz, I_circ, n_sample_rows=16)
    assert 0 < report["residual_rel_max"] < 1e-12
    assert report["sampled_row_rel_disagreement"] < 1e-12


def test_final_refine_polishes_a_terminal_sweep():
    """A bias sweep gives the terminal film per-point offsets ``(B, n)``."""
    device = st.device_from_reference(_mini_strip())
    model = st.factorize_model(device=device, current_units="mA", torch_device="cpu")
    drives = [{"strip": {"source": i, "drain": -i}} for i in (0.5, 1.0, 2.0)]
    fields = [st.sources.ConstantField(v) for v in (0.0, 0.3, 0.6)]
    result = st.solve_many(
        model=model, applied_fields=fields, terminal_currents=drives, final_refine=2,
        torch_device="cpu",
    )
    assert result.streams["strip"].dtype == np.float64
    assert result.final_refine_report["residual_rel_max_after"] < 1e-9
    film_data, _ = port_sweep._apply_terminal_sweeps(model, model.film_data, drives, 3, "mA")
    assert film_data["strip"].g_offset.shape == (3, film_data["strip"].n)
    conv = port_utils.field_conversion_factor(
        "mT", "mA", length_units=device.length_units, ureg=device.ureg
    ).magnitude
    Hz = {"strip": (result.applied_fields["strip"] * conv).astype(np.float32)}
    check = certify.certify_sweep(
        film_data, result.streams, None, Hz, refine_steps=0, n_sample_rows=8
    )
    assert check["residual_rel_max"] < 1e-8
