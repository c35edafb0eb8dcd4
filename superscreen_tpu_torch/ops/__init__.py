"""Numerical operators: FEM operators, pairwise kernels, dense linear algebra."""
