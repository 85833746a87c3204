"""The benchmark's plain reference (`decide.py`): the fused decision worked
out again from the plain world description, in NumPy, from the semantics
that the JAX package states. Nothing here imports the program or JAX, and
nothing takes what the program made.
"""
