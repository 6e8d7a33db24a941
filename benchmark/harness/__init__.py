"""The benchmark's own code: traffic generation, the entry modules' shared
pieces, the metric arithmetic, the trace reading and the check."""
