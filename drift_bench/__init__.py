"""The benchmark of the PyTorch and CUDA port (``opendrift_tpu_torch``):
whole forecasts through its public entry points, timed as users wait for
them.  ``python3 -m drift_bench.run --help``."""
