"""messyerraytracer.accel"""
