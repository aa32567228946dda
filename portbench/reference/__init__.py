"""The benchmark's plain reference: PyTorch and NumPy only, nothing of the
port (portbench/tests/test_imports.py holds it to that)."""
