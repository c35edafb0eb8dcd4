"""The port's public API against the JAX package's, parameter by parameter.

For every public module and package ``__init__`` of ``superscreen_tpu``, its
public names (``__all__``, else the names it binds to objects of the
package) must exist in the port's module of the same name, and for every
public callable (function, class, public method) a call the JAX package
accepts must bind in the port: the JAX positional parameters are a prefix
of the port's, every JAX parameter exists in the port (or the port takes
``**kwargs``), a JAX default is the port's default (package names aside),
and the port requires nothing the JAX package does not.  The one rule for
all: the port may add ``torch_device`` (its device policy, ROADMAP).
Every other difference is an entry of ``ALLOWED`` with its reason: the
by-design list of ROADMAP.md.  An entry no difference needs fails the
test too.

Also the calls of fault 3.13, which raised ``TypeError`` in the port."""

import importlib
import importlib.util
import inspect
import os
import pkgutil
import types

import numpy as np
import pytest

import superscreen_tpu as sc
import superscreen_tpu_torch as st

_TPU = "TPU-only machinery, replaced by the port's own (ROADMAP, not carried over by design)"
_ROUTE = "tile and route knobs of the TPU kernels: the port's kernels follow the tensor's dtype and fix their own geometry"
_F64 = "float64 wrapper of solver/refine.py: the port's kernels take float64 tensors directly"
_INTERNAL = "solver-internal container whose fields hold the port's own tensors (gather tables, LU and permutation, sweep data)"

ALLOWED = {
    ("module", "ops.pallas_kernels"): "replaced by the hand-written CUDA kernels in csrc/",
    ("module", "utils"): _TPU,
    ("module", "utils.profiling"): _TPU,
    ("module", "utils.tunnel"): _TPU,
    ("name", "ops.fem", "coo_matvec"): "removed as dead: COO.matvec is the gather form",
    ("name", "ops", "coo_matvec"): "removed as dead: COO.matvec is the gather form",
    ("name", "ops.kernels", "C_vector_masked"): "padding to 2048 multiples is not carried over",
    ("name", "ops.linalg", "lu_factor"): "the port factors with ops.linalg.factor_system",
    ("name", "ops.linalg", "brandt_cg_solve"): "the jitted solvers; the port's are the _host loops",
    ("name", "ops.linalg", "brandt_bicgstab_solve"): "the jitted solvers; the port's are the _host loops",
    **{
        ("name", "solver.refine", name): _F64
        for name in (
            "C_vector64", "biot_savart_film_to_film64", "biot_savart_within_film64",
            "boundary_effective_field64", "coo_matvec64", "q_apply64", "q_block64",
            "q_row_sums64",
        )
    },
    ("param", "ops.kernels.q_matrix", "dtype"): _ROUTE,
    ("param", "ops.kernels.q_matrix", "block"): _ROUTE,
    ("param", "ops.kernels.Q_matrix", "dtype"): _ROUTE,
    ("param", "ops.kernels.Q_matrix", "block"): _ROUTE,
    ("param", "ops.kernels.C_vector", "dtype"): _ROUTE,
    ("param", "ops.kernels.q_apply", "block"): _ROUTE,
    ("param", "ops.kernels.q_apply", "use_pallas"): _ROUTE,
    ("param", "ops.kernels.Q_apply", "block"): _ROUTE,
    ("param", "ops.kernels.biot_savart_film_to_film", "block"): _ROUTE,
    ("param", "ops.kernels.biot_savart_film_to_film_dz2", "block"): _ROUTE,
    ("param", "ops.kernels.biot_savart_film_to_film_dz2", "use_pallas"): _ROUTE,
    ("param", "ops.kernels.biot_savart_film_to_film_dz2", "precision"): _ROUTE,
    ("param", "ops.kernels.biot_savart_within_film", "block"): _ROUTE,
    ("param", "ops.kernels.biot_savart_2d_field", "block"): _ROUTE,
    ("param", "ops.fem.coo_to_dense", "like"): "COO.to_dense(like='jax') is not carried over",
    ("param", "ops.fem.COO.to_dense", "like"): "COO.to_dense(like='jax') is not carried over",
    ("param", "ops.fem.COO.to_dense", "dtype"): "the port's to_dense builds a tensor of the dtype asked for",
    ("param", "solver.solve_film.LinearSystem", "grad_Lambda_term"): "grad_Lambda_term is folded into A",
    ("param", "adjoint.AdjointModel", "dtype"): "AdjointModel.dtype follows the tensors; the model carries its torch device",
    ("param", "solver.utils.FilmInfo", "<order>"): _INTERNAL,
    ("param", "solver.utils.FilmInfo", "sites"): _INTERNAL,
    ("param", "solver.solve.FactorizedModel", "<order>"): _INTERNAL,
    ("param", "solver.solve.FactorizedModel", "film_data"): _INTERNAL,
    **{
        ("param", "adjoint.FilmAdjointData", name): "FilmAdjointData's triplets: the port keeps gather tables"
        for name in (
            "<order>", "Q", "Qw", "lap_rows", "lap_cols", "lap_vals", "gx_rows", "gx_cols",
            "gx_vals", "gy_rows", "gy_cols", "gy_vals", "boundary_ix", "fwb",
            "boundary_centers", "boundary_lengths", "boundary_normals", "gtx_rows",
            "gtx_cols", "gtx_vals", "gty_rows", "gty_cols", "gty_vals", "lambda_pattern",
            "lambda_map", "gradient_x", "gradient_y", "interior_block",
        )
    },
    **{
        ("param", "sweep.FilmSweepData", name): "FilmSweepData's padding fields and interior_sites; the factors tuple and Q diag(w) of the port"
        for name in ("<order>", "n_valid", "fac_a", "fac_b", "Q", "interior_sites", "factors", "Qw")
    },
}


def _modules(package):
    """Dotted names (relative to the package) of its Python source modules."""
    names = [""]
    for info in pkgutil.walk_packages(package.__path__, package.__name__ + "."):
        origin = importlib.util.find_spec(info.name).origin or ""
        if origin.endswith(".py"):
            names.append(info.name[len(package.__name__) + 1:])
    return names


def _import(package, name):
    return importlib.import_module(package.__name__ + ("." + name if name else ""))


def _public(module):
    if hasattr(module, "__all__"):
        return set(module.__all__)
    return {
        name for name, value in vars(module).items()
        if not name.startswith("_") and not isinstance(value, types.ModuleType)
        and (getattr(value, "__module__", None) or "").startswith("superscreen_tpu.")
    }


def _callables(module, names):
    """``{qualified name: callable}``: functions, classes and their public
    methods, keyed by where the JAX package defines them."""
    out = {}
    for name in sorted(names):
        value = getattr(module, name, None)
        if callable(value) and hasattr(value, "__wrapped__"):
            value = inspect.unwrap(value)  # a jitted function
        if not (inspect.isclass(value) or inspect.isfunction(value)):
            continue
        where = value.__module__.replace("superscreen_tpu_torch", "superscreen_tpu")
        qual = f"{where[len('superscreen_tpu.'):]}.{value.__qualname__}"
        out[qual] = (name, value)
        if inspect.isclass(value):
            for attr, member in vars(value).items():
                if isinstance(member, (staticmethod, classmethod)):
                    member = member.__func__
                if not attr.startswith("_") and inspect.isfunction(member):
                    out[f"{qual}.{attr}"] = (f"{name}.{attr}", member)
    return out


def _resolve(module, dotted):
    """``name`` or ``Class.method`` of ``module``; a method as it is
    defined (a class or static method unwrapped, as on the JAX side)."""
    name, _, method = dotted.partition(".")
    obj = getattr(module, name, None)
    if method and obj is not None:
        obj = inspect.getattr_static(obj, method, None)
        if isinstance(obj, (staticmethod, classmethod)):
            obj = obj.__func__
    return obj


def _default(param):
    if param.default is inspect.Parameter.empty:
        return None
    return repr(param.default).replace("superscreen_tpu_torch", "superscreen_tpu")


def _param_diff(qual, ref, port):
    """The keys of the ways a call that ``ref`` accepts fails in ``port``."""
    found = set()
    try:
        rs, ps = inspect.signature(ref), inspect.signature(port)
    except (TypeError, ValueError):
        return found
    rp, pp = rs.parameters, ps.parameters

    def positional(params):
        return [
            p.name for p in params.values()
            if p.kind in (p.POSITIONAL_ONLY, p.POSITIONAL_OR_KEYWORD) and p.name != "torch_device"
        ]

    # The positional parameters both have come in the same places (a
    # missing one is reported by name).
    r_pos, p_pos = positional(rp), positional(pp)
    r_common = [name for name in r_pos if name in p_pos]
    if p_pos[: len(r_common)] != r_common:
        found.add(("param", qual, "<order>"))
    port_kwargs = any(p.kind == p.VAR_KEYWORD for p in pp.values())
    for name, p in rp.items():
        if p.kind in (p.VAR_POSITIONAL, p.VAR_KEYWORD):
            if not any(q.kind == p.kind for q in pp.values()):
                found.add(("param", qual, f"*{name}"))
        elif name not in pp:
            if not port_kwargs:
                found.add(("param", qual, name))
        elif _default(p) is not None and _default(p) != _default(pp[name]):
            found.add(("param", qual, name))
    for name, q in pp.items():
        required = q.default is inspect.Parameter.empty and q.kind not in (
            q.VAR_POSITIONAL, q.VAR_KEYWORD
        )
        if required and name not in rp and name != "torch_device":
            found.add(("param", qual, name))
    return found


def _api_differences():
    found = set()
    port_modules = set(_modules(st))
    for name in _modules(sc):
        if name not in port_modules:
            found.add(("module", name))
            continue
        ref, port = _import(sc, name), _import(st, name)
        names = _public(ref)
        found |= {("name", name, n) for n in names if not hasattr(port, n)}
        for qual, (path, ref_obj) in _callables(ref, names).items():
            port_obj = _resolve(port, path)
            if port_obj is None:
                found.add(("name", name, path))
            elif callable(port_obj):
                found |= _param_diff(qual, ref_obj, port_obj)
    return found


@pytest.fixture(scope="module")
def differences():
    return _api_differences()


def test_every_api_difference_is_allowed(differences):
    unexpected = sorted(differences - set(ALLOWED), key=str)
    assert not unexpected, unexpected


def test_every_allowed_difference_is_still_there(differences):
    stale = sorted(set(ALLOWED) - differences, key=str)
    assert not stale, stale


def test_the_diff_sees_what_it_should():
    """The diff reports a missing parameter, a changed default and a new
    required parameter."""

    def ref(a, b=1, *, c="superscreen_tpu.solve"):
        pass

    def port(a, *, c="superscreen_tpu_torch.solve", torch_device="cuda"):
        pass

    def strict(a, b=2, *, c="x", d):
        pass

    assert _param_diff("f", ref, port) == {("param", "f", "b")}
    assert _param_diff("f", ref, strict) == {("param", "f", n) for n in ("b", "c", "d")}
    assert _param_diff("f", ref, ref) == set()


# -- fault 3.13 --------------------------------------------------------------


def _disk(pkg):
    t = np.linspace(0, 2 * np.pi, 60, endpoint=False)
    points = np.stack([2 * np.cos(t), 2 * np.sin(t)], axis=1)
    film = pkg.Polygon("disk", layer="base", points=points)
    device = pkg.Device(
        "disk", layers=[pkg.Layer("base", Lambda=0.1, z0=0)], films=[film], length_units="um"
    )
    return device, points


@pytest.mark.parametrize(
    "mesh_kwargs", [dict(min_angle=30), dict(extra_points=[[0.1, 0.2]]),
                    dict(min_angle=30, extra_points=[[0.1, 0.2], [-0.3, 0.5]])],
    ids=["min_angle", "extra_points", "both"],
)
def test_make_mesh_keywords_give_the_jax_mesh(mesh_kwargs):
    (ref, _), (port, _) = _disk(sc), _disk(st)
    ref.make_mesh(max_edge_length=0.4, **mesh_kwargs)
    port.make_mesh(max_edge_length=0.4, **mesh_kwargs)
    a, b = ref.meshes["disk"], port.meshes["disk"]
    assert 300 < len(b.sites) < 600
    np.testing.assert_array_equal(b.sites, a.sites)
    np.testing.assert_array_equal(b.elements, a.elements)
    for xy in mesh_kwargs.get("extra_points", []):
        assert (np.abs(b.sites - xy).max(axis=1) == 0).any()


@pytest.mark.parametrize("radius", [0.01, -0.01, 0.3])
def test_in_polygon_radius_matches_jax(radius):
    _, points = _disk(st)
    assert st.fem.in_polygon(points, [[2, 0]], radius=0.01) is True
    rng = np.random.default_rng(2)
    queries = np.concatenate([rng.uniform(-2.2, 2.2, (3000, 2)), points, [[2.0, 0.0]]])
    for ring in (points, points[::-1]):
        np.testing.assert_array_equal(
            st.ops.fem.in_polygon(ring, queries, radius=radius),
            sc.fem.in_polygon(ring, queries, radius=radius),
        )
    assert st.fem.in_polygon(points, [2, 0], radius=radius) == sc.fem.in_polygon(
        points, [2, 0], radius=radius
    )


@pytest.mark.parametrize("convex_hull", [False, True])
def test_generate_mesh_boundary_and_convex_hull_match_jax(convex_hull):
    star = st.geometry.circle(2, points=40) * (1 + 0.3 * np.cos(5 * np.linspace(0, 2 * np.pi, 40)))[:, None]
    kwargs = dict(max_edge_length=0.35, convex_hull=convex_hull, min_angle=20, foo=1)
    if not convex_hull:
        kwargs["boundary"] = st.geometry.circle(3, points=50)
    a = sc.device.mesh_generation.generate_mesh(star, **kwargs)
    b = st.device.mesh_generation.generate_mesh(star, **kwargs)
    for x, y in zip(a, b):
        np.testing.assert_array_equal(y, x)
    with pytest.raises(ValueError, match="convex_hull"):
        st.device.mesh_generation.generate_mesh(star, convex_hull=True, boundary=star)
    mesh = st.Polygon("p", layer="l", points=star).make_mesh(max_edge_length=0.35, convex_hull=True)
    assert len(mesh.sites) == len(a[0]) if convex_hull else True


def test_gradient_vertices_weighting_matches_jax():
    mesh = sc.Polygon("p", layer="l", points=sc.geometry.circle(1, points=30)).make_mesh(
        max_edge_length=0.3
    )
    for weighting in ("first_vertex", "shared_vertex"):
        ref = sc.ops.fem.gradient_vertices_coo(mesh.sites, mesh.elements, weighting=weighting)
        port = st.ops.fem.gradient_vertices_coo(mesh.sites, mesh.elements, weighting=weighting)
        for r, p in zip(ref, port):
            np.testing.assert_array_equal(p.rows, r.rows)
            np.testing.assert_allclose(p.vals, r.vals, rtol=1e-12, atol=1e-12)
    with pytest.raises(ValueError, match="weighting"):
        st.ops.fem.gradient_vertices_coo(mesh.sites, mesh.elements, weighting="nope")


def test_mesh_constructor_takes_the_jax_arguments():
    ref = sc.Polygon("p", layer="l", points=sc.geometry.circle(1, points=30)).make_mesh(
        max_edge_length=0.3
    )
    args = [ref.sites, ref.elements, ref.triangle_centroids, ref.boundary_indices,
            ref.vertex_areas, ref.triangle_areas]
    mesh = st.Mesh(*args, st.EdgeMesh.from_mesh(ref.sites, ref.elements), build_operators=False)
    np.testing.assert_array_equal(mesh.triangle_centroids, ref.triangle_centroids)
    np.testing.assert_allclose(mesh.edge_mesh.edges, ref.edge_mesh.edges)
    assert mesh.operators is None
    built = st.Mesh(*args, None)  # None: built on first use
    np.testing.assert_array_equal(built.edge_mesh.edges, mesh.edge_mesh.edges)
    assert built.operators is not None


def test_buffer_takes_single_sided_and_solve_names_its_solver():
    polygon = st.Polygon("p", layer="l", points=st.geometry.box(2, 1))
    np.testing.assert_array_equal(
        polygon.buffer(0.1, single_sided=True).points, polygon.buffer(0.1).points
    )
    device = st.Device("d", layers=[st.Layer("l", Lambda=1.0)], films=[
        st.Polygon("f", layer="l", points=st.geometry.circle(1, points=20))
    ])
    device.make_mesh(max_edge_length=0.5)
    default, = st.solve(device, torch_device="cpu")
    named, = st.solve(device, _solver="mine", torch_device="cpu")
    assert default.solver == "superscreen_tpu_torch.solve" and named.solver == "mine"


@pytest.mark.parametrize("order", ["jax_first", "port_first"])
def test_mesh_cache_keys_with_mesh_kwargs_are_shared(tmp_path, monkeypatch, order):
    """With meshing keywords, the port writes the entry the JAX package
    would (the same file name, from the same key string), and each package
    hits the other's entry."""
    monkeypatch.setenv("SUPERSCREEN_TPU_MESH_CACHE", str(tmp_path))
    kwargs = dict(max_edge_length=0.4, min_angle=30, extra_points=[[0.1, 0.2]])
    first, second = (sc, st) if order == "jax_first" else (st, sc)
    (device, _), (other, _) = _disk(first), _disk(second)
    device.make_mesh(**kwargs)
    stored = sorted(os.listdir(tmp_path))
    assert len(stored) == 1
    other.make_mesh(**kwargs)
    assert sorted(os.listdir(tmp_path)) == stored
    np.testing.assert_array_equal(other.meshes["disk"].sites, device.meshes["disk"].sites)
    np.testing.assert_array_equal(other.meshes["disk"].elements, device.meshes["disk"].elements)
    # Other keywords, another key.
    other.make_mesh(max_edge_length=0.4, min_angle=31, extra_points=[[0.1, 0.2]])
    assert len(os.listdir(tmp_path)) == 2


def test_the_port_reexports_what_the_jax_package_does():
    from superscreen_tpu_torch.device.layer import Parameter
    from superscreen_tpu_torch.ops import Q_matrix, cdist, in_polygon

    assert Parameter is st.Parameter
    assert in_polygon is st.ops.fem.in_polygon and cdist is st.ops.kernels.cdist
    assert Q_matrix is st.ops.kernels.Q_matrix
    assert not hasattr(st.ops, "coo_matvec")
