"""Image preprocessing for the detection forward."""
