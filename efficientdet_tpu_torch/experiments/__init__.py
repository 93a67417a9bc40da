"""The port's counterparts of the JAX package's ``experiments/``: the fused
stride-1 MBConv harnesses, the early-backbone chain, the tap floor, the int8
microbenchmark and the stage-1 packing formulations; the numpy-drawn
weights that the card's checks run on (``drawn_weights``); and the folded
model's custom ops call by call (``folded_ops``)."""
