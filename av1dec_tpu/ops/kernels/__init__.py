"""Device (JAX/XLA) kernels — the device-side compute path.

Each kernel has a NumPy spec-model twin under ``av1dec_tpu.ops.spec``;
tests assert bit-exact agreement (SURVEY.md §4 unit tier).
"""
