"""One float32 training step of the reduced D4 against the JAX package's, on the CPU.

The sizes, weights and tolerances are in tests/torch_entry_train.py; here
also remat against no remat with stochastic depth on.
"""

from torch_entry_train import *  # noqa: F401,F403  (the tests and their fixtures)
from torch_entry_train import stepped_for
from torch_entry_train import test_remat_matches_no_remat_with_stochastic_depth  # noqa: F401

stepped = stepped_for(4)
