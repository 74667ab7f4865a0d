"""The benchmark of ``tracer_torch``, the PyTorch and CUDA port.

Run one cell once with ``python3 benchmark/run.py --workload <name> --seed
<n> --seconds <s> --trace <0|1>``; ``README.md`` beside this file says where
each kind of file goes. Nothing here imports JAX or the JAX package.
"""
