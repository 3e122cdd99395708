"""The strided engine: lazy views, the fused map/reduce engine and its kernels."""
