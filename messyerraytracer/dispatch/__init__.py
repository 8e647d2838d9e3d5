"""messyerraytracer.dispatch"""
