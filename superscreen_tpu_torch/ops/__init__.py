"""Numerical operators: FEM operators, pairwise kernels, dense linear algebra.

The JAX package's ``ops`` names, from the port's counterparts (its
``coo_matvec`` is not carried over: ``COO.matvec`` is the gather form)."""
from .fem import (
    COO,
    adjacency_matrix,
    build_laplacian_coo,
    coo_to_dense,
    gradient_triangles_coo,
    gradient_vertices_coo,
    in_polygon,
    laplace_operator,
    triangle_areas,
    vertex_areas,
)
from .kernels import (
    C_vector,
    Q_matrix,
    biot_savart_2d_field,
    biot_savart_film_to_film,
    biot_savart_within_film,
    boundary_effective_field,
    cdist,
    q_matrix,
)
