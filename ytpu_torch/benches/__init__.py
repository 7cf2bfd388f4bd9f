"""The port's counterparts of the JAX package's fault-isolation programs
(`benches/mosaic_ladder.py`, `benches/plane_rmw_repro*.py`): each TPU
kernel there is a hand-written CUDA kernel here, beside its plain PyTorch
version. The programs return their results and write no file.
"""
