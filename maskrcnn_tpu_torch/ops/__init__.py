"""Box ops, anchors, FPN levels, NMS and ROIAlign on torch tensors."""
