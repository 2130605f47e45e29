"""Mask R-CNN in plain torch: the benchmark's reference.

A frozen copy of the port's plain code paths (the layers, ResNet-50-FPN and
Darknet backbones, RPN, proposals, targets, losses, the FPN mask and
keypoint heads) with the pointwise ROIAlign in place of the hand-written
pools and the Jacobi fixpoint in place of the NMS kernel. It imports
nothing of the program and takes from it no weights and no tables: the
benchmark hands both sides the same inputs.
"""
