// geomcore: the host geometry core of superscreen_tpu_torch.
//
// A small, dependency-free C++ core with a plain C ABI (bound from Python
// with ctypes, see __init__.py), the same routines as the JAX package's
// native core plus one:
//
//   * delaunay(points) -> triangles: incremental Bowyer-Watson Delaunay
//     triangulation with walk-based point location, plain double-precision
//     orient2d / incircle predicates on pre-jittered inputs.
//   * points_in_polygon: batch even-odd ray casting.
//   * segments_intersect_batch: pairwise proper-intersection tests.
//   * points_in_ring: matplotlib's point_in_path crossing test for a
//     closed path (the same float64 expressions as the NumPy
//     points_in_ring_plain, so points on an edge are decided alike),
//     with the ring's edges bucketed by y so that each point visits only
//     the edges that can straddle it.
//
// Build: c++ -O3 -std=c++17 -shared -fPIC -ffp-contract=off geomcore.cpp
// (-ffp-contract=off keeps every product and sum rounded on its own, as
// NumPy rounds them, on compilers that would contract to FMA).

#include <cmath>
#include <cstdint>
#include <cstring>
#include <vector>
#include <algorithm>

namespace {

struct Tri {
    int v[3];        // vertex indices
    int adj[3];      // adjacent triangle index across edge (v[i], v[i+1]); -1 = hull
    bool alive;
};

static inline double orient2d(
    double ax, double ay, double bx, double by, double cx, double cy) {
    // Positive if (a, b, c) is counterclockwise.  Plain double-precision
    // sign; callers pre-jitter the inputs below the mesh resolution so
    // exactly degenerate configurations (cocircular lattices, circular
    // boundary rings) do not occur.
    return (bx - ax) * (cy - ay) - (by - ay) * (cx - ax);
}

static inline double incircle(
    double ax, double ay, double bx, double by,
    double cx, double cy, double dx, double dy) {
    // Positive if d is strictly inside the circumcircle of CCW (a, b, c).
    const double adx = ax - dx, ady = ay - dy;
    const double bdx = bx - dx, bdy = by - dy;
    const double cdx = cx - dx, cdy = cy - dy;
    const double ad2 = adx * adx + ady * ady;
    const double bd2 = bdx * bdx + bdy * bdy;
    const double cd2 = cdx * cdx + cdy * cdy;
    return adx * (bdy * cd2 - cdy * bd2)
         - ady * (bdx * cd2 - cdx * bd2)
         + ad2 * (bdx * cdy - cdx * bdy);
}

struct Delaunator {
    const double* pts;  // (n + 3) * 2 with the super-triangle appended
    int n_total;
    std::vector<Tri> tris;
    int last_alive = 0;

    int opposed_index(int t, int nb) const {
        // Index i such that tris[nb].adj[i] == t.
        for (int i = 0; i < 3; i++) {
            if (tris[nb].adj[i] == t) return i;
        }
        return -1;
    }

    bool point_in_tri(int t, double x, double y) const {
        const Tri& T = tris[t];
        for (int i = 0; i < 3; i++) {
            const int a = T.v[i], b = T.v[(i + 1) % 3];
            if (orient2d(pts[2 * a], pts[2 * a + 1],
                         pts[2 * b], pts[2 * b + 1], x, y) < 0) {
                return false;
            }
        }
        return true;
    }

    int locate(double x, double y) {
        // Walk from the last created triangle toward (x, y).
        int t = last_alive;
        if (!tris[t].alive) {
            for (int i = (int)tris.size() - 1; i >= 0; i--) {
                if (tris[i].alive) { t = i; break; }
            }
        }
        for (int steps = 0; steps < (int)tris.size() + 8; steps++) {
            const Tri& T = tris[t];
            int next = -1;
            for (int i = 0; i < 3; i++) {
                const int a = T.v[i], b = T.v[(i + 1) % 3];
                if (orient2d(pts[2 * a], pts[2 * a + 1],
                             pts[2 * b], pts[2 * b + 1], x, y) < 0) {
                    next = T.adj[i];
                    break;
                }
            }
            if (next < 0) return t;  // inside (or on hull -- super-tri covers all)
            t = next;
        }
        // Fallback: exhaustive search (should not happen).
        for (int i = 0; i < (int)tris.size(); i++) {
            if (tris[i].alive && point_in_tri(i, x, y)) return i;
        }
        return -1;
    }

    void insert(int p) {
        const double x = pts[2 * p], y = pts[2 * p + 1];
        int t0 = locate(x, y);
        if (t0 < 0) return;

        // Bowyer-Watson cavity: flood fill over triangles whose
        // circumcircle contains p.
        std::vector<int> cavity;
        std::vector<char> in_cavity(tris.size(), 0);
        std::vector<int> stack = {t0};
        in_cavity[t0] = 1;
        while (!stack.empty()) {
            int t = stack.back(); stack.pop_back();
            cavity.push_back(t);
            for (int i = 0; i < 3; i++) {
                int nb = tris[t].adj[i];
                if (nb < 0 || in_cavity[nb] || !tris[nb].alive) continue;
                const Tri& N = tris[nb];
                if (incircle(pts[2 * N.v[0]], pts[2 * N.v[0] + 1],
                             pts[2 * N.v[1]], pts[2 * N.v[1] + 1],
                             pts[2 * N.v[2]], pts[2 * N.v[2] + 1],
                             x, y) > 0) {
                    in_cavity[nb] = 1;
                    stack.push_back(nb);
                }
            }
        }
        // Boundary edges of the cavity: edges whose neighbor is outside.
        struct BEdge { int a, b, outer, outer_idx; };
        std::vector<BEdge> boundary;
        for (int t : cavity) {
            for (int i = 0; i < 3; i++) {
                int nb = tris[t].adj[i];
                if (nb < 0 || !in_cavity[nb]) {
                    BEdge e;
                    e.a = tris[t].v[i];
                    e.b = tris[t].v[(i + 1) % 3];
                    e.outer = nb;
                    // Index of the shared edge within the OUTER triangle.
                    e.outer_idx = (nb >= 0) ? opposed_index(t, nb) : -1;
                    boundary.push_back(e);
                }
            }
        }
        for (int t : cavity) tris[t].alive = false;
        // Retriangulate: one new triangle (a, b, p) per boundary edge.
        std::vector<int> new_ids(boundary.size());
        for (size_t k = 0; k < boundary.size(); k++) {
            Tri T;
            T.v[0] = boundary[k].a;
            T.v[1] = boundary[k].b;
            T.v[2] = p;
            T.adj[0] = boundary[k].outer;
            T.adj[1] = -2;  // fixed below
            T.adj[2] = -2;
            T.alive = true;
            new_ids[k] = (int)tris.size();
            tris.push_back(T);
            if (boundary[k].outer >= 0) {
                tris[boundary[k].outer].adj[boundary[k].outer_idx] = new_ids[k];
            }
        }
        // Link the new triangles around p by matching shared edges
        // (edge (b, p) of one triangle == edge (p, a) of the next).
        for (size_t k = 0; k < boundary.size(); k++) {
            for (size_t m = 0; m < boundary.size(); m++) {
                if (k == m) continue;
                if (boundary[k].b == boundary[m].a) {
                    tris[new_ids[k]].adj[1] = new_ids[m];  // edge (b, p)
                    tris[new_ids[m]].adj[2] = new_ids[k];  // edge (p, a)
                }
            }
        }
        last_alive = new_ids.empty() ? last_alive : new_ids[0];
    }
};

}  // namespace

extern "C" {

// Delaunay triangulation of n 2D points.
// points: n*2 doubles.  out_tris: capacity max_tris*3 ints.
// Returns the number of triangles written, or -1 if capacity exceeded,
// or -2 on internal failure.
int delaunay(const double* points, int n, int* out_tris, int max_tris) {
    if (n < 3) return 0;
    // Bounding super-triangle.
    double xmin = points[0], xmax = points[0];
    double ymin = points[1], ymax = points[1];
    for (int i = 1; i < n; i++) {
        xmin = std::min(xmin, points[2 * i]);
        xmax = std::max(xmax, points[2 * i]);
        ymin = std::min(ymin, points[2 * i + 1]);
        ymax = std::max(ymax, points[2 * i + 1]);
    }
    const double cx = 0.5 * (xmin + xmax), cy = 0.5 * (ymin + ymax);
    const double span = std::max(xmax - xmin, ymax - ymin) + 1.0;
    std::vector<double> all((n + 3) * 2);
    std::memcpy(all.data(), points, sizeof(double) * 2 * n);
    // Far-away super-triangle: hull slivers are only lost if their
    // circumradius exceeds this scale (relative area < 1e-10 -- irrelevant
    // for meshing, and double precision still resolves the predicates).
    const double big = 1.0e5 * span;
    all[2 * n + 0] = cx - 2.0 * big; all[2 * n + 1] = cy - big;
    all[2 * (n + 1) + 0] = cx + 2.0 * big; all[2 * (n + 1) + 1] = cy - big;
    all[2 * (n + 2) + 0] = cx; all[2 * (n + 2) + 1] = cy + 2.0 * big;

    Delaunator D;
    D.pts = all.data();
    D.n_total = n + 3;
    Tri super;
    super.v[0] = n; super.v[1] = n + 1; super.v[2] = n + 2;
    super.adj[0] = super.adj[1] = super.adj[2] = -1;
    super.alive = true;
    D.tris.push_back(super);

    // Insert points in a spatially coherent order (Hilbert-ish: sort by
    // Morton-like interleave of quantized coords) for fast walking.
    std::vector<int> order(n);
    for (int i = 0; i < n; i++) order[i] = i;
    const double inv = 1024.0 / (span + 1e-300);
    std::sort(order.begin(), order.end(), [&](int a, int b) {
        auto key = [&](int i) -> uint64_t {
            uint32_t xi = (uint32_t)((points[2 * i] - xmin) * inv);
            uint32_t yi = (uint32_t)((points[2 * i + 1] - ymin) * inv);
            uint64_t k = 0;
            for (int bit = 0; bit < 16; bit++) {
                k |= ((uint64_t)((xi >> bit) & 1)) << (2 * bit);
                k |= ((uint64_t)((yi >> bit) & 1)) << (2 * bit + 1);
            }
            return k;
        };
        return key(a) < key(b);
    });
    for (int i : order) D.insert(i);

    int count = 0;
    for (const Tri& T : D.tris) {
        if (!T.alive) continue;
        if (T.v[0] >= n || T.v[1] >= n || T.v[2] >= n) continue;  // super-tri
        if (count >= max_tris) return -1;
        out_tris[3 * count + 0] = T.v[0];
        out_tris[3 * count + 1] = T.v[1];
        out_tris[3 * count + 2] = T.v[2];
        count++;
    }
    return count;
}

// Even-odd point-in-polygon for a batch of query points.
// poly: m*2 doubles (open ring). query: n*2. out: n bytes (0/1).
void points_in_polygon(
    const double* poly, int m, const double* query, int n, uint8_t* out) {
    for (int k = 0; k < n; k++) {
        const double x = query[2 * k], y = query[2 * k + 1];
        bool inside = false;
        for (int i = 0, j = m - 1; i < m; j = i++) {
            const double xi = poly[2 * i], yi = poly[2 * i + 1];
            const double xj = poly[2 * j], yj = poly[2 * j + 1];
            if (((yi > y) != (yj > y)) &&
                (x < (xj - xi) * (y - yi) / (yj - yi) + xi)) {
                inside = !inside;
            }
        }
        out[k] = inside ? 1 : 0;
    }
}

// Whether each segment pair (a0[i]->a1[i], b0[i]->b1[i]) properly
// intersects (strictly interior crossing).  out: n bytes.
void segments_intersect_batch(
    const double* a0, const double* a1, const double* b0, const double* b1,
    int n, uint8_t* out) {
    for (int i = 0; i < n; i++) {
        const double p0x = a0[2 * i], p0y = a0[2 * i + 1];
        const double p1x = a1[2 * i], p1y = a1[2 * i + 1];
        const double q0x = b0[2 * i], q0y = b0[2 * i + 1];
        const double q1x = b1[2 * i], q1y = b1[2 * i + 1];
        const double rx = p1x - p0x, ry = p1y - p0y;
        const double sx = q1x - q0x, sy = q1y - q0y;
        const double denom = rx * sy - ry * sx;
        if (denom == 0.0) { out[i] = 0; continue; }
        const double qpx = q0x - p0x, qpy = q0y - p0y;
        const double t = (qpx * sy - qpy * sx) / denom;
        const double u = (qpx * ry - qpy * rx) / denom;
        out[i] = (t > 0.0 && t < 1.0 && u > 0.0 && u < 1.0) ? 1 : 0;
    }
}

// matplotlib's point_in_path for the closed ring (m vertices, the last
// one replaced by the first as CLOSEPOLY does) at radius 0: per edge
// v0 -> v1 a point with (y1 >= ty) != (y0 >= ty) toggles when
// ((y1 - ty) * (x0 - x1) >= (x1 - tx) * (y0 - y1)) == (y1 >= ty).
// An edge toggles a point only if ty lies in (min(y0, y1), max(y0, y1)].
// So the edges are bucketed into horizontal slabs, each edge into every
// slab from that of its lower to that of its upper end, and a point tests
// only the edges of its own slab, in ring order.  The slab index is a
// monotone function of y (a subtraction, a product by a positive scale
// and a floor, each rounded monotonically), so every edge that straddles
// ty is in ty's slab; an extra edge there changes nothing, the test
// being the exact expression above.  out: n bytes (0/1).
void points_in_ring(
    const double* ring, int m, const double* query, int n, uint8_t* out) {
    std::memset(out, 0, (size_t)(n > 0 ? n : 0));
    if (m < 3 || n <= 0) return;
    const int ne = m - 1;  // edges v[i] -> v[i + 1], with v[m - 1] := v[0]
    std::vector<double> x(m), y(m);
    for (int i = 0; i < m; i++) {
        const int j = (i == m - 1) ? 0 : i;
        x[i] = ring[2 * j];
        y[i] = ring[2 * j + 1];
    }
    double ylo = y[0], yhi = y[0];
    for (int i = 1; i < m; i++) {
        ylo = std::min(ylo, y[i]);
        yhi = std::max(yhi, y[i]);
    }
    std::vector<int> lo(ne), hi(ne), first, edges;
    int nslab = std::max(1, std::min(ne, 4096));
    for (;;) {
        const double scale = (yhi > ylo) ? nslab / (yhi - ylo) : 0.0;
        auto slab = [&](double v) {
            const double s = std::floor((v - ylo) * scale);
            if (!(s >= 0)) return 0;  // below the ring, or NaN
            if (s > nslab - 1) return nslab - 1;
            return (int)s;
        };
        long long total = 0;
        for (int i = 0; i < ne; i++) {
            lo[i] = slab(std::min(y[i], y[i + 1]));
            hi[i] = slab(std::max(y[i], y[i + 1]));
            total += hi[i] - lo[i] + 1;
        }
        // Long edges over many slabs: fewer, wider slabs bound the table.
        if (total > 16LL * ne + nslab && nslab > 1) {
            nslab = std::max(1, nslab / 4);
            continue;
        }
        first.assign(nslab + 1, 0);
        for (int i = 0; i < ne; i++) {
            for (int s = lo[i]; s <= hi[i]; s++) first[s + 1]++;
        }
        for (int s = 0; s < nslab; s++) first[s + 1] += first[s];
        std::vector<int> fill(first.begin(), first.end() - 1);
        edges.assign(first[nslab], 0);
        for (int i = 0; i < ne; i++) {
            for (int s = lo[i]; s <= hi[i]; s++) edges[fill[s]++] = i;
        }
        for (int k = 0; k < n; k++) {
            const double tx = query[2 * k], ty = query[2 * k + 1];
            if (!(ty > ylo) || ty > yhi) continue;  // no edge straddles ty
            const int s = slab(ty);
            bool inside = false;
            for (int e = first[s]; e < first[s + 1]; e++) {
                const int i = edges[e];
                const double x0 = x[i], y0 = y[i], x1 = x[i + 1], y1 = y[i + 1];
                const bool yflag1 = y1 >= ty;
                if ((y0 >= ty) != yflag1 &&
                    (((y1 - ty) * (x0 - x1) >= (x1 - tx) * (y0 - y1)) == yflag1)) {
                    inside = !inside;
                }
            }
            out[k] = inside ? 1 : 0;
        }
        return;
    }
}

}  // extern "C"
