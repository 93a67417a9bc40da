"""EfficientDet-D1, D2 and D3 at full width and depth, 90 classes, batch 1, against the
JAX package on the CPU (B1-B3 backbones, BiFPN depths 4-6, D1 at 640 px (P7 5 x 5), D2 and D3 at
384 px (P7 3 x 3)).

The fixtures, the tests and their tolerances are in tests/torch_family.py.
"""

from torch_family import *  # noqa: F401,F403  (the tests and their fixtures)
from torch_family import family_for

family = family_for([1, 2, 3])
