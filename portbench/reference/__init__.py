"""The plain reference of the benchmark's configurations: float32
PyTorch with TF32 off, functional over a state_dict in the reference
key layout, importing nothing of ``scat_tpu_torch``, ``scat_tpu`` or
JAX.  ``common.Numerics`` puts every product's operands in float32 or,
for the control, in float8 (e4m3, one scale a tensor)."""
