"""messyerraytracer.render"""
