"""Framework-wide constants, mirroring the reference's compile-time values
(``CudaTracer/CudaTracer.h:6-7``, ``CudaTracer/CudaUtils.h:7``,
``CudaTracer/CudaTracer.h:39``) — but runtime-configurable where the
reference hardcoded them."""

RAY_BUMP_EPSILON = 1e-4          # CudaTracer.h:6
GAMMA_CORRECTION = 1.0 / 2.2     # CudaTracer.h:7
INV_PI = 0.31830988618           # CudaTracer.h:4 (INVERSE_PI)

DEFAULT_MAX_BOUNCES = 15         # CudaTracer.h:39 (maxIterations)
DEFAULT_DIM = 512                # CudaUtils.h:7 (DIM)
