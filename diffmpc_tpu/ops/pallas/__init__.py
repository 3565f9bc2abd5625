"""Pallas kernels (Triton route) for the GPU: the iLQR mega-kernel and the
fused KKT backward, with their shared entry math and launch."""
