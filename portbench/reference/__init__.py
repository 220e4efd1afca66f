"""The plain reference the benchmark holds the port's results against,
written from the equations of barotropic Rossby-wave ray tracing in plain
PyTorch and NumPy (float64 unless asked): the basic state
(``state.py``), and the background sample, the dispersion roots, the group
velocity, the ray equations and the RK4 step (``rays.py``). It imports
nothing of the port and nothing of JAX."""
