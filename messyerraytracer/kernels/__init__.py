"""messyerraytracer.kernels"""
