"""The plain reference: the reference tracer's semantics in plain PyTorch.

It imports neither JAX, nor the JAX package, nor anything of the port, and
takes nothing the port made: it reads the benchmark's inputs (spheres,
rays, camera poses, noise) and computes every answer again. Each function
takes a ``dtype``: float32, the precision the configurations state, for the
reference, and bfloat16 for the control that a comparison has to fail.
"""
