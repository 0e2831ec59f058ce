"""The plain reference of the benchmark: the upstream's semantics in float64
NumPy and PyTorch, independent of the program under test (it imports nothing
of it), and the same arithmetic in TF32 as the check's control."""
