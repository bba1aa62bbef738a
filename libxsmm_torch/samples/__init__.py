"""The samples of samples/, on the port.

Each module is named after its counterpart in samples/ and runs as

    python -m libxsmm_torch.samples.<name> [arguments] [--device cpu]

with that sample's arguments and defaults. Each does its work in
`main(argv=None) -> int`, which returns the sample's exit code; nothing
runs at import. They run on the card (--device cuda, the default) and raise
without one; --device cpu runs the kernels' plain versions. Their data come
from the same numpy seeds as the samples'. Times on the card are taken with
CUDA events (utils/timer.py); on the CPU a sample times by the host clock
and says so, and prints no figure as the card's.

    hello           the four TPPs of the walkthrough
    eltwise         the random meltw sweep
    equation        the 11 matrix-equation drivers
    xgemm           the GEMM acceptance matrix (random draw, --full, --bench)
    smmbench        the five streaming SMM cases
    dispatch_bench  dispatch, invoke and native-registry costs
    utilities       copy, transpose and random-number rates, the CRC
    spmm            every BCSC strategy against the dense product
    probe_bcsc      the BCSC dense and union strategies stage by stage
    cnn             the fused conv layer against cuDNN
    pyfr            fsspmdm over the PyFR operator set
    spmm_scaling    the distributed BSR SpMM in worlds of 1 to 8 ranks
    encoder         the generated text's structure, then the AOT round trip
"""
