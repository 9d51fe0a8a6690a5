"""The benchmark's harness: the run, the traffic generator, the seeded
weights, the yardstick's arithmetic, the trace reading and the import
check."""
