"""messyerraytracer.debug"""
