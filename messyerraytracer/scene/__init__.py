"""messyerraytracer.scene"""
