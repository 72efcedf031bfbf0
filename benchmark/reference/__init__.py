"""The plain reference of the chain in NumPy (float32), and its bfloat16
control. It imports nothing of juicy_tpu_torch, JAX or the JAX package,
and takes nothing that the program made: it works the chain's state out
anew from the inputs and the configuration file."""
