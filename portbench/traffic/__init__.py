"""One module a traffic kind: ``<kind>.py`` exposes ``run(bench)``."""
