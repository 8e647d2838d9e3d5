"""messyerraytracer.api"""
