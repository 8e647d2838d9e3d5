"""messyerraytracer.core"""
