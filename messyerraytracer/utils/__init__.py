"""messyerraytracer.utils"""
