"""Detection ops: boxes, anchors, normalisation, NMS (kernel K1), proposals, ROIAlign (kernel K2)."""
