"""EfficientDet-D4 and D5 at full width and depth, 90 classes, batch 1, against the
JAX package on the CPU (B4 and B5 backbones, BiFPN depth 7, head depth 4, at 384 px (P7 3 x 3)).

The fixtures, the tests and their tolerances are in tests/torch_family.py.
"""

from torch_family import *  # noqa: F401,F403  (the tests and their fixtures)
from torch_family import family_for

family = family_for([4, 5])
