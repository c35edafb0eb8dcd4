"""The plain reference that decides ``correct``: NumPy and plain PyTorch
only, written from the method (Brandt's kernel on a Delaunay mesh, the
London equation restricted to each film's interior, Biot-Savart coupling
between films).  It imports nothing of the measured program and takes
nothing it made: it works everything out again from the frozen meshes and
the configuration file."""
