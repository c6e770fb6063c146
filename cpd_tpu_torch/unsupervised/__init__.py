"""Geometry helpers of the JAX package's pseudo-label factory that the Waymo
reader needs (port of parts of cpd_tpu/unsupervised). The factory itself
(PPScore, outline boxes, C-PROTO refinement, tracking) is not ported yet."""
