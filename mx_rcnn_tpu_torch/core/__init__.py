"""Inference core: Predictor and the eval/serve postprocess."""
