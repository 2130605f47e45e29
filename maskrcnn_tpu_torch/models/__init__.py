"""Backbone, RPN, ROI head and the MaskRCNN facade."""
