"""Headless map and frame views, and the live HTTP viewer.

Counterpart of orbslam2_tpu/viz/, which stands in for the reference's
Pangolin Viewer, FrameDrawer and MapDrawer (src/Viewer.cpp,
src/FrameDrawer.cpp, src/MapDrawer.cpp). The JAX package renders with
matplotlib; this package draws on a numpy canvas of its own (raster.py) and
encodes the PNGs itself (io/png.write_png), so it runs where matplotlib is
not installed.
"""
