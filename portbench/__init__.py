"""The benchmark of the PyTorch and CUDA port (``repro_torch``).

``run.py`` runs one cell: a CNN configuration (``configs/``) served by the
port under a traffic mix (``traffic/``), its answers checked against the
plain reference (``reference/``), its per-layer metrics read by the files
of ``metrics/``.  Nothing here imports JAX or the JAX package ``repro``.
"""
