"""Throughput benchmarks of the port: the counterparts of the JAX
repository's `benchmarks/timing.py` (the slope estimator) and
`benchmarks/throughput.py` (the runner behind the `benchmark` subcommand),
timing the port's own train step and `Trainer.fit`."""
