"""Core of the port: routing, device resolution, the grouped-GEMM backend
registry and the MoEBlaze expert layer."""
