"""Host-side data helpers of the port (the datasets are not ported yet)."""
