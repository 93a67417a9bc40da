"""EfficientDet-D6 and D7 at full width and depth, 90 classes, batch 1, against the
JAX package on the CPU (the B6 backbone, the unweighted BiFPN fusion of depth 8, head depth 5,
D7's anchor scale 5, at 384 px (P7 3 x 3)), drawn at conv gain 1 with calibrated BN statistics
(``torch_family.CALIBRATED``), so that their scores lie below saturation.

The fixtures, the tests and their tolerances are in tests/torch_family.py.
"""

from torch_family import *  # noqa: F401,F403  (the tests and their fixtures)
from torch_family import family_for

family = family_for([6, 7])
