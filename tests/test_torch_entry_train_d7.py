"""One float32 training step of the reduced D7 against the JAX package's, on the CPU.

The sizes, weights and tolerances are in tests/torch_entry_train.py.
"""

from torch_entry_train import *  # noqa: F401,F403  (the tests and their fixtures)
from torch_entry_train import stepped_for

stepped = stepped_for(7)
