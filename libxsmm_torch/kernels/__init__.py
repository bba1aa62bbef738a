"""Hand-written CUDA kernels (csrc/) with their wrappers and plain torch
versions. Nothing is built at import: kernels/_build.py compiles csrc/ with
nvcc at the first launch."""
