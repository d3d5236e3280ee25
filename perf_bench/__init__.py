"""The benchmark of the PyTorch/CUDA port (``improved_body_parts_tpu_torch``):
``run.py`` runs one cell of ``BENCHMARK.json``; ``core`` finds its files."""
