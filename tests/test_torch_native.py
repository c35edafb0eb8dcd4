"""The port's geometry core (``superscreen_tpu_torch.native``) against the JAX
package's native core, SciPy, matplotlib and its own NumPy twin, on the
CPU: Delaunay bit for bit, the ring test bit for bit on points placed on
edges and vertices, the mesher's output, and the build that raises instead
of falling back."""

import os
import subprocess
import sys

import numpy as np
import pytest
from matplotlib.path import Path
from scipy import spatial

import superscreen_tpu as sc
import superscreen_tpu_torch as st
from superscreen_tpu import native as ref_native
from superscreen_tpu_torch import native
from superscreen_tpu_torch.device import mesh_generation
from superscreen_tpu_torch.device.polygon import points_in_ring, points_in_ring_plain

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))


def _hex_lattice(n_side=40):
    x, y = np.meshgrid(np.arange(n_side, dtype=float), np.arange(n_side) * np.sqrt(3) / 2)
    x[1::2] += 0.5
    return np.stack([x.ravel(), y.ravel()], axis=1)


def _cocircular_ring():
    t = np.linspace(0, 2 * np.pi, 400, endpoint=False)
    outer = np.stack([np.cos(t), np.sin(t)], axis=1)
    return np.concatenate([3 * outer, 2 * outer[::2], [[0.0, 0.0]]])


def _random_set():
    return np.random.default_rng(12).uniform(-5, 5, size=(3000, 2))


POINT_SETS = {"hex_lattice": _hex_lattice, "cocircular_ring": _cocircular_ring, "random": _random_set}


def test_jax_native_core_is_built_here():
    # Every comparison below is against the JAX package's native routines.
    assert ref_native.available()


@pytest.mark.parametrize("points", list(POINT_SETS))
def test_delaunay_matches_jax_native_bitwise(points):
    pts = POINT_SETS[points]()
    got = native.delaunay(pts)
    ref = ref_native.delaunay(pts)
    assert got.dtype == np.int64 and got.shape[1] == 3
    np.testing.assert_array_equal(got, ref)
    # Counterclockwise, as SciPy returns its triangles.
    assert (mesh_generation.triangle_areas(pts, got) >= 0).all()


def _rows(tris):
    return set(map(tuple, np.sort(tris, axis=1).tolist()))


def test_delaunay_matches_scipy_on_a_random_set():
    pts = _random_set()
    got, ref = _rows(native.delaunay(pts)), _rows(spatial.Delaunay(pts).simplices)
    # The far super-triangle may drop a couple of hull slivers.
    assert len(got ^ ref) <= 4 and len(got - ref) == 0


def _ring_and_queries(rng):
    """A closed star-shaped ring and query points inside, outside, exactly
    on its vertices and exactly on its edges (at dyadic fractions)."""
    t = np.linspace(0, 2 * np.pi, 97, endpoint=False)
    r = 2 + 0.5 * np.sin(5 * t)
    ring = np.stack([r * np.cos(t), r * np.sin(t)], axis=1)
    # Axis-aligned edges and vertices on the query grid too.
    ring = np.concatenate([ring, [[3.0, 1.0], [3.0, -1.0]]])
    ring = ring[np.argsort(np.arctan2(ring[:, 1], ring[:, 0]))]
    ring = np.concatenate([ring, ring[:1]])
    a, b = ring[:-1], ring[1:]
    frac = rng.integers(1, 8, size=(len(a), 1)) / 8
    on_edges = a + frac * (b - a)
    grid = np.stack(np.meshgrid(np.linspace(-3, 3, 49), np.linspace(-3, 3, 49)), -1).reshape(-1, 2)
    queries = np.concatenate([rng.uniform(-3, 3, (4000, 2)), ring, on_edges, grid])
    return ring, queries


def test_ring_test_matches_plain_and_matplotlib_bitwise():
    ring, queries = _ring_and_queries(np.random.default_rng(3))
    got = native.points_in_ring(ring, queries)
    np.testing.assert_array_equal(got, points_in_ring_plain(ring, queries))
    np.testing.assert_array_equal(got, Path(ring, closed=True).contains_points(queries))
    np.testing.assert_array_equal(points_in_ring(ring, queries), got)
    assert 0 < got.sum() < len(queries)


@pytest.mark.parametrize("ring", ["open", "reversed", "degenerate", "empty_queries"])
def test_ring_test_edge_cases_match_plain(ring):
    square = np.array([[0, 0], [1, 0], [1, 1], [0, 1], [0, 0]], dtype=float)
    queries = np.array([[0.5, 0.5], [0, 0], [1, 0.5], [0.5, 1], [2, 2], [0.5, 0], [np.nan, 0.5]])
    if ring == "open":
        # The last vertex is replaced by the first, as matplotlib's
        # CLOSEPOLY does: the edge (1, 1) -> (0, 1) is then the closing one.
        square = square[:-1]
    elif ring == "reversed":
        square = square[::-1]
    elif ring == "degenerate":
        square = square[:2]
    elif ring == "empty_queries":
        queries = queries[:0]
    got = native.points_in_ring(square, queries)
    assert got.dtype == bool and got.shape == (len(queries),)
    np.testing.assert_array_equal(got, points_in_ring_plain(square, queries))


@pytest.mark.parametrize(
    "call",
    [
        lambda: native.points_in_ring(np.zeros((4, 3)), np.zeros((2, 2))),
        lambda: native.points_in_polygon(np.zeros((4, 2)), np.zeros((2, 1))),
        lambda: native.delaunay(np.zeros((5, 3))),
        lambda: native.segments_intersect_batch(*(np.zeros((n, 2)) for n in (2, 2, 2, 3))),
    ],
    ids=["ring", "queries", "delaunay", "segment_lengths"],
)
def test_coordinates_of_another_shape_raise(call):
    # The routines read two doubles per point: anything else would read
    # past the buffers.
    with pytest.raises(ValueError):
        call()


def test_points_in_polygon_and_segments_match_jax_native():
    rng = np.random.default_rng(5)
    poly = np.stack([np.cos(np.linspace(0, 6, 40)), np.sin(np.linspace(0, 6, 40))], 1) * 2
    queries = np.concatenate([rng.uniform(-2.5, 2.5, (2000, 2)), poly, 0.5 * (poly[1:] + poly[:-1])])
    np.testing.assert_array_equal(
        native.points_in_polygon(poly, queries), ref_native.points_in_polygon(poly, queries)
    )
    a0, a1, b0, b1 = (rng.uniform(-1, 1, (3000, 2)) for _ in range(4))
    b1[:500] = a1[:500]  # touching at an end: not a proper crossing
    b0[500:1000], b1[500:1000] = a0[500:1000], a1[500:1000]  # collinear
    got = native.segments_intersect_batch(a0, a1, b0, b1)
    np.testing.assert_array_equal(got, ref_native.segments_intersect_batch(a0, a1, b0, b1))
    assert 0 < got.sum() < len(got)


def _ring_with_hole(pkg, max_edge_length):
    layer = pkg.Layer("base", Lambda=0.5, z0=0)
    film = pkg.Polygon("ring", layer="base", points=pkg.geometry.circle(3, points=120))
    hole = pkg.Polygon("hole", layer="base", points=pkg.geometry.circle(1, points=60))
    device = pkg.Device("d", layers=[layer], films=[film], holes=[hole])
    device.make_mesh(max_edge_length=max_edge_length, smooth=20)
    return device.meshes["ring"]


@pytest.mark.parametrize("max_edge_length", [0.8, 0.35])
def test_make_mesh_matches_jax_mesh_exactly(max_edge_length, monkeypatch):
    ref = _ring_with_hole(sc, max_edge_length)
    got = _ring_with_hole(st, max_edge_length)
    assert 250 < len(got.sites) < 2500
    np.testing.assert_array_equal(got.sites, ref.sites)
    np.testing.assert_array_equal(got.elements, ref.elements)
    # The plain routes: the same sites and the same triangles, in SciPy's
    # order.
    monkeypatch.setenv("SUPERSCREEN_TPU_NATIVE", "0")
    assert not native.available()
    plain = _ring_with_hole(st, max_edge_length)
    np.testing.assert_array_equal(plain.sites, ref.sites)
    assert _rows(plain.elements) == _rows(ref.elements)


class _FailingCore:
    @staticmethod
    def delaunay(*args):
        return -1


def test_a_failed_triangulation_meshes_with_scipy_and_is_counted(monkeypatch):
    pts = _hex_lattice(10) + np.random.default_rng(0).uniform(0, 1e-3, (100, 2))
    monkeypatch.setattr(native, "load_library", lambda: _FailingCore)
    before = native.STATS["delaunay_fallbacks"]
    assert native.delaunay(pts) is None
    np.testing.assert_array_equal(mesh_generation._delaunay(pts), spatial.Delaunay(pts).simplices)
    assert native.STATS["delaunay_fallbacks"] == before + 2


def _run(code, **env):
    return subprocess.run(
        [sys.executable, "-c", code], capture_output=True, text=True, timeout=300, cwd=REPO,
        env={**os.environ, **env},
    )


def test_a_missing_compiler_raises_and_nothing_falls_back():
    code = (
        "import sys\n"
        "for name in ('jax', 'jaxlib', 'superscreen_tpu'):\n"
        "    sys.modules[name] = None\n"
        "import numpy as np, superscreen_tpu_torch as st\n"
        "from superscreen_tpu_torch import native\n"
        "for call in (native.available, lambda: native.delaunay(np.eye(3)),\n"
        "             lambda: st.Polygon('p', layer='l', points=st.geometry.circle(1)).make_mesh()):\n"
        "    try:\n"
        "        call()\n"
        "    except RuntimeError as exc:\n"
        "        print('raised', '/nonexistent' in str(exc))\n"
    )
    out = _run(code, CXX="/nonexistent", SUPERSCREEN_TPU_NATIVE="1")
    assert out.returncode == 0, out.stderr[-2000:]
    assert out.stdout.split("\n")[:3] == ["raised True"] * 3, out.stdout


def test_the_plain_routes_need_no_compiler():
    code = (
        "import superscreen_tpu_torch as st\n"
        "from superscreen_tpu_torch import native\n"
        "mesh = st.Polygon('p', layer='l', points=st.geometry.circle(1)).make_mesh(min_points=200)\n"
        "print(native.available(), len(mesh.sites) >= 200)\n"
    )
    out = _run(code, CXX="/nonexistent", SUPERSCREEN_TPU_NATIVE="0")
    assert out.returncode == 0, out.stderr[-2000:]
    assert out.stdout.split("\n")[0] == "False True"


def test_concurrent_first_builds_all_load(tmp_path):
    """Four processes build a new library (a compiler at a new path: a new
    name) at once; each loads a whole file."""
    cxx = tmp_path / "g++"
    cxx.symlink_to(native.compiler())
    code = (
        "import numpy as np\n"
        "from superscreen_tpu_torch import native\n"
        "tris = native.delaunay(np.random.default_rng(1).uniform(size=(200, 2)))\n"
        "print(len(tris), native.STATS['build_seconds'] is not None)\n"
    )
    procs = [
        subprocess.Popen(
            [sys.executable, "-c", code], stdout=subprocess.PIPE, stderr=subprocess.PIPE,
            text=True, cwd=REPO, env={**os.environ, "CXX": str(cxx)},
        )
        for _ in range(4)
    ]
    outs = [p.communicate(timeout=300) for p in procs]
    assert all(p.returncode == 0 for p in procs), [err[-500:] for _, err in outs]
    counts = {out.split()[0] for out, _ in outs}
    assert len(counts) == 1 and int(counts.pop()) > 300
    # At least the first process compiled (others may find its file).
    assert any(out.split()[1] == "True" for out, _ in outs)
