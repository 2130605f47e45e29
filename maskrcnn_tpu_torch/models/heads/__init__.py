"""ROI heads."""
