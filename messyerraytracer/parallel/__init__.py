"""messyerraytracer.parallel"""
