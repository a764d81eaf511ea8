"""95th percentile of the gaps between successive tokens of one request,
over every request's gaps that end inside the window (ms): ``itl_p95_ms``'s
number, read per layer in the cells where it swings too widely between
runs to hold a bound.  A gap is one iteration of the front end's loop for
that lane: its replica's tick and every admission taken that iteration."""

from bench.metrics.itl_p95_ms import read  # noqa: F401
