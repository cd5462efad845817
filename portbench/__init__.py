"""The benchmark of ``single_algebra_tpu_torch``, the PyTorch and CUDA port.

``run.py`` runs one cell of ``BENCHMARK.json``; ``control.py`` runs the
plain reference in the program's place at TF32 precision (the control of
the comparison that decides ``correct``). Neither imports JAX or the JAX
package.
"""
