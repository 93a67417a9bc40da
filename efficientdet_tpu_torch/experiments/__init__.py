"""The port's counterparts of the JAX package's ``experiments/``: the fused
stride-1 MBConv harnesses, the early-backbone chain and the tap floor."""
