"""Framework-wide constants, mirroring the reference's compile-time values
(``CudaTracer/CudaTracer.h:6-7``, ``CudaTracer/CudaUtils.h:7``,
``CudaTracer/CudaTracer.h:39``) — but runtime-configurable where the
reference hardcoded them."""

RAY_BUMP_EPSILON = 1e-4          # CudaTracer.h:6
GAMMA_CORRECTION = 1.0 / 2.2     # CudaTracer.h:7
INV_PI = 0.31830988618           # CudaTracer.h:4 (INVERSE_PI)

DEFAULT_MAX_BOUNCES = 15         # CudaTracer.h:39 (maxIterations)
DEFAULT_DIM = 512                # CudaUtils.h:7 (DIM)

# Ceiling of every MIS density ratio and chain carry of the bidirectional
# weights, applied before the ratio is squared or carried on: a density that
# underflows would otherwise run a ratio to inf, and inf * 0 (a gate, a zero
# lobe) is NaN. 1e18 squares to 1e36, inside float32; at the ceiling the
# competing weight is already 0 to ~1e-36.
MIS_RATIO_CLAMP = 1e18
