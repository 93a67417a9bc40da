"""The benchmark's shared arithmetic. A later change adds modules beside these."""
