"""The general parts of the benchmark: lookup by name, the closed job loop,
tracing, the check against the reference, and the result line."""
