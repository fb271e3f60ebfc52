"""Plain reference of the benchmark's training cells.

NumPy and plain PyTorch only: nothing here imports the program under test,
its kernels or its helpers (``tests/test_gbdt_bench_imports.py`` holds it
to that).
"""
