"""The port's fluxoid tools and mutual-inductance matrix against the
``superscreen_tpu`` ones on the same device and mesh (through
``device_from_reference``), at float64 on the CPU."""

import numpy as np
import pytest
import torch

import superscreen_tpu as sc
import superscreen_tpu.geometry as geo
import superscreen_tpu_torch as st

torch.set_num_threads(2)

# The tolerance of the streams behind the fluxoids (float64 on both sides).
RTOL = 1e-8
# find_fluxoid_solution solves for the currents through the mutual
# inductance matrix: one more linear solve on top of the streams.
FLUXOID_RTOL = 1e-6


def _two_rings():
    layers = [sc.Layer("layer0", Lambda=1, z0=0), sc.Layer("layer1", Lambda=0.5, z0=1)]
    films = [
        sc.Polygon("big_ring", layer="layer0", points=geo.circle(7.5, points=80)),
        sc.Polygon("little_ring", layer="layer1", points=geo.circle(5, points=60)),
    ]
    holes = [
        sc.Polygon("big_hole", layer="layer0", points=geo.circle(3.75, points=40)),
        sc.Polygon("little_hole", layer="layer1", points=geo.circle(2.5, points=30)),
    ]
    device = sc.Device("two_rings", layers=layers, films=films, holes=holes, solve_dtype="float64")
    device.make_mesh(max_edge_length=1.0)
    return device


def _holey_strip():
    """A strip with a source, a drain and two holes: a terminal device, so
    its mutual inductances take the per-column route."""
    film = sc.Polygon("film", layer="base", points=geo.box(2, 4, points=60))
    source = sc.Polygon("source", points=geo.box(2, 0.04, center=(0, 2)))
    drain = sc.Polygon("drain", points=geo.box(2, 0.04, center=(0, -2)))
    holes = [
        sc.Polygon("hole1", layer="base", points=geo.circle(0.4, points=20, center=(0, 1))),
        sc.Polygon("hole2", layer="base", points=geo.circle(0.4, points=20, center=(0, -1))),
    ]
    device = sc.Device(
        "holey", layers=[sc.Layer("base", Lambda=0.2)], films=[film], holes=holes,
        terminals={"film": [source, drain]}, solve_dtype="float64",
    )
    device.make_mesh(max_edge_length=0.25)
    return device


@pytest.fixture(scope="module")
def rings():
    ref = _two_rings()
    return ref, st.device_from_reference(ref)


def _assert_matrix_close(got, expected, rtol=RTOL):
    got, expected = np.asarray(got.magnitude), np.asarray(expected.magnitude)
    assert got.shape == expected.shape
    np.testing.assert_allclose(got, expected, rtol=0, atol=rtol * np.abs(expected).max())


@pytest.mark.parametrize("kwargs", [{}, dict(holes="little_hole"), dict(holes=["big_hole"]),
                                    dict(join_style="round"), dict(interp_points=101)])
def test_make_fluxoid_polygons(rings, kwargs):
    ref, port = rings
    expected = sc.make_fluxoid_polygons(ref, **kwargs)
    got = st.make_fluxoid_polygons(port, **kwargs)
    assert list(got) == list(expected)
    for name, contour in expected.items():
        np.testing.assert_allclose(got[name], contour, rtol=0, atol=1e-12)


def test_mutual_inductance_matrix_batched(rings):
    ref, port = rings
    expected = ref.mutual_inductance_matrix(iterations=3)
    got = port.mutual_inductance_matrix(iterations=3, torch_device="cpu")
    assert str(got.units) == str(expected.units)
    _assert_matrix_close(got, expected)
    M = np.asarray(got.magnitude)
    assert abs(M[0, 1] - M[1, 0]) < 0.05 * abs(M[0, 1])


def test_mutual_inductance_matrix_all_iterations_and_units(rings):
    ref, port = rings
    expected = ref.mutual_inductance_matrix(iterations=2, all_iterations=True, units="Phi_0 / A")
    got = port.mutual_inductance_matrix(
        iterations=2, all_iterations=True, units="Phi_0 / A", torch_device="cpu"
    )
    assert len(got) == len(expected) == 3
    for a, b in zip(got, expected):
        _assert_matrix_close(a, b)


def test_mutual_inductance_matrix_with_given_polygons(rings):
    ref, port = rings
    mapping = {"big_hole": geo.circle(5.0, points=90), "little_hole": geo.circle(3.5, points=70)}
    expected = ref.mutual_inductance_matrix(hole_polygon_mapping=mapping, iterations=1)
    got = port.mutual_inductance_matrix(
        hole_polygon_mapping=mapping, iterations=1, torch_device="cpu"
    )
    _assert_matrix_close(got, expected)
    with pytest.raises(ValueError, match="does not exist"):
        port.mutual_inductance_matrix({"no_hole": mapping["big_hole"]}, torch_device="cpu")
    with pytest.raises(ValueError, match="not completely contained"):
        port.mutual_inductance_matrix(
            {"big_hole": geo.circle(1.0, points=20)}, torch_device="cpu"
        )


def test_mutual_inductance_matrix_per_column_for_a_terminal_device():
    ref = _holey_strip()
    port = st.device_from_reference(ref)
    expected = ref.mutual_inductance_matrix()
    got = port.mutual_inductance_matrix(torch_device="cpu")
    _assert_matrix_close(got, expected)
    # The same loop, asked for by name on a device without terminals.
    rings_ref = _two_rings()
    rings_port = st.device_from_reference(rings_ref)
    _assert_matrix_close(
        rings_port.mutual_inductance_matrix(
            iterations=2, all_iterations=True, use_batched_solver=False, torch_device="cpu"
        )[-1],
        rings_ref.mutual_inductance_matrix(iterations=2),
    )


def test_mutual_inductance_matrix_defaults_to_the_card(rings):
    _, port = rings
    if torch.cuda.is_available():
        pytest.skip("a card is present")
    with pytest.raises(RuntimeError, match="no CUDA device"):
        port.mutual_inductance_matrix()
    with pytest.raises(RuntimeError, match="no CUDA device"):
        st.find_fluxoid_solution(port, {"big_hole": 1})


def test_find_fluxoid_solution(rings):
    ref, port = rings
    targets = {"big_hole": 1, "little_hole": -2}
    ref_model = sc.factorize_model(device=ref, current_units="uA")
    port_model = st.factorize_model(device=port, current_units="uA", torch_device="cpu")
    port_model.set_circulating_currents({"big_hole": 3.0})
    expected = sc.find_fluxoid_solution(
        ref_model, targets, applied_field=sc.sources.ConstantField(0.05), iterations=3
    )
    got = st.find_fluxoid_solution(
        port_model, targets, applied_field=st.sources.ConstantField(0.05), iterations=3,
        torch_device="cpu",
    )
    # The model's own currents are restored.
    assert port_model.circulating_currents == {"big_hole": 3.0}
    for hole, target in targets.items():
        assert abs(got.circulating_currents[hole] - expected.circulating_currents[hole]) <= (
            FLUXOID_RTOL * abs(expected.circulating_currents[hole])
        )
        fluxoid = sum(got.hole_fluxoid(hole)).to("Phi_0").magnitude
        assert abs(fluxoid - target) < 1e-3
    for name, fs in expected.film_solutions.items():
        np.testing.assert_allclose(
            got.film_solutions[name].stream, fs.stream, rtol=0,
            atol=FLUXOID_RTOL * np.abs(fs.stream).max(),
        )


def test_find_fluxoid_solution_from_a_device_and_without_holes(rings):
    ref, port = rings
    expected = sc.find_fluxoid_solution(ref, {"little_hole": 1}, iterations=1)
    got = st.find_fluxoid_solution(port, {"little_hole": 1}, iterations=1, torch_device="cpu")
    for hole, current in expected.circulating_currents.items():
        assert abs(got.circulating_currents[hole] - current) <= FLUXOID_RTOL * abs(current)
    disk = sc.Device(
        "disk", layers=[sc.Layer("base", Lambda=1)],
        films=[sc.Polygon("disk", layer="base", points=geo.circle(2, points=40))],
        solve_dtype="float64",
    )
    disk.make_mesh(max_edge_length=0.5)
    port_disk = st.device_from_reference(disk)
    with pytest.raises(ValueError, match="no holes"):
        st.find_fluxoid_solution(port_disk, {"hole": 1}, torch_device="cpu")
    solution = st.find_fluxoid_solution(
        port_disk, applied_field=st.sources.ConstantField(0.1), torch_device="cpu"
    )
    reference = sc.find_fluxoid_solution(disk, applied_field=sc.sources.ConstantField(0.1))
    np.testing.assert_allclose(
        solution.film_solutions["disk"].stream, reference.film_solutions["disk"].stream,
        rtol=0, atol=RTOL * np.abs(reference.film_solutions["disk"].stream).max(),
    )
