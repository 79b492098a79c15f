"""The benchmark of the PyTorch and CUDA port (``repro_torch``): Orloj serving
under fixed SLOs and rates through the port's own event loop.  See
``run.py`` for the command and ``harness.py`` for a run."""
