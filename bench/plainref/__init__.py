"""Plain references for the benchmark's correctness checks.

Written from the published descriptions in plain PyTorch and NumPy, with no
kernels, caches or batching tricks.  Nothing here imports the program under
test or the JAX package: each module works out again, from the weights and
inputs the benchmark made, what the program derived.

* :mod:`llama` — a LLaMA-style multi-head attention decoder in float32.
* :mod:`mamba1` — a Mamba-1 stack run as the sequential recurrence, with
  Falcon-Mamba's RMS-normalised B / C / dt.
* :mod:`heft_rt` — the HEFT_RT mapping event of the paper, in float32.
* :mod:`precision` — the float32 reference and its lower-precision control.

A model's reference is a module here that defines ``parameters(cfg)``,
``hidden`` and ``logits``, and a module-level ``SMOKE`` dict: the model at
a small float32 size for the benchmark's CPU tests.  The tests find every
such module by its file (``bench/tests/smoke.py`` ``references``), so a
new reference is tested by adding its file alone.
"""
