"""The port's counterparts of the repository's ``tools/``: device time by
stage of a profiler trace (``analyze_trace``) and the weights-day drill
(``parity_run``). Each runs as ``python -m efficientdet_tpu_torch.tools.<name>``."""
