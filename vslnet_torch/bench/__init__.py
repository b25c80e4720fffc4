"""Card-only measurements behind the kernels' design (PERF.md cites them)."""
