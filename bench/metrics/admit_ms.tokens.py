"""``admit_ms``'s median admission, in the cells that report no
``itl_p95_ms``: there it moves the tokens a second (an iteration that
admits ticks no lane meanwhile)."""

from bench.metrics.admit_ms import read  # noqa: F401
