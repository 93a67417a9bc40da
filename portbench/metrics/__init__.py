"""One reader a per-layer metric: ``<name>.py``, the name's dots written as
``__``, exposes ``read(bench)`` -> a number, or None where there is nothing
to read."""
